"""Training-step benchmark: steps/s, windows/s, counted FLOPs and MFU on one
GPU (counterpart of ``mmtraj/benchmarks/train_bench.py``).

It times the step ``mmtraj_torch.train`` runs (``make_train_step``: draws,
objective, backward, clipped AdamW) on config 4 at full width with random
windows, and reports:

- steps/s and windows/s, on the host clock around ``iters`` steps closed by
  a synchronize (``iters`` sized to last ``min_seconds``);
- FLOPs a step, counted by ``torch.utils.flop_counter.FlopCounterMode`` over
  one eager step (forward and backward, the checkpoint recomputation
  included) of the plain route at the same shape: the kernels do the same
  products, so the count is the same work whatever implements it;
- ``mfu`` against the H100's 67 TFLOP/s float32 peak outside the tensor
  cores (on the card only);
- each kernel's launches in one step;
- with ``--profile``, where a step's time goes under ``torch.profiler``: the
  host's enqueue time, the device's busy share, kernels a step and the
  largest device times.

Run:  python -m mmtraj_torch.benchmarks.train_bench --batch 16 --use-pallas
      python -m mmtraj_torch.benchmarks.train_bench --loss variety --profile
      python -m mmtraj_torch.benchmarks.train_bench --device cpu --batch 2 --n-max 8 --iters 2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time
from collections import defaultdict
from typing import Optional

import numpy as np
import torch

from mmtraj_torch.benchmarks.bench import F32_PEAK, count_flops, count_launches, sync
from mmtraj_torch.config import config4
from mmtraj_torch.data.transforms import NormStats
from mmtraj_torch.models.forecaster import Forecaster, resolve_device
from mmtraj_torch.params import init_params
from mmtraj_torch.train import make_optimizer, make_train_step


@dataclasses.dataclass
class TrainBenchResult:
    batch_size: int
    route: str
    loss: str
    remat: bool
    steps_per_sec: float
    windows_per_sec: float
    flops_per_step: Optional[float]
    mfu: Optional[float]
    launches_per_step: dict
    device: str


def fake_batch(batch_size: int, n_max: int, t_total: int, device, seed: int = 0):
    """Random-walk windows and a univ-like, about 2/3 full mask (the JAX
    package's ``_fake_batch``) -> (xy, mask) on ``device``."""
    rng = np.random.default_rng(seed)
    steps = rng.normal(scale=0.15, size=(batch_size, n_max, t_total, 2))
    xy = np.cumsum(steps, axis=2) + rng.uniform(0, 12, size=(batch_size, n_max, 1, 2))
    n_valid = rng.integers(max(1, n_max // 2), n_max + 1, size=batch_size)
    mask = np.arange(n_max)[None, :] < n_valid[:, None]
    return (torch.tensor(xy, dtype=torch.float32, device=device),
            torch.tensor(mask, device=device))


def _setup(batch_size, remat, n_max, use_pallas, attend_kernel, loss_mode, variety_n, dev):
    cfg = config4()
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, remat=remat, use_pallas=use_pallas,
                                  **({"attend_kernel": attend_kernel} if attend_kernel else {})),
        train=dataclasses.replace(cfg.train, batch_size=batch_size))
    model = Forecaster(cfg.model, cfg.data.obs_len, cfg.data.pred_len, device=dev,
                       state=init_params(cfg.model, torch.Generator().manual_seed(0)))
    stats = NormStats(np.zeros(2, np.float32), np.ones(2, np.float32))
    step_fn = make_train_step(model, make_optimizer(cfg, model), stats, loss_mode=loss_mode,
                              variety_n=variety_n)
    xy, mask = fake_batch(batch_size, n_max, cfg.data.obs_len + cfg.data.pred_len, dev)
    return cfg, step_fn, xy, mask


def bench_train_step(batch_size: int = 128, remat: bool = True, n_max: int = 64,
                     iters: int = 30, warmup: int = 3, use_pallas: bool = False,
                     attend_kernel: Optional[str] = None, min_seconds: float = 3.0,
                     loss_mode: str = "nll", variety_n: int = 8, device="cuda",
                     flops: bool = True) -> TrainBenchResult:
    """Time the config-4 training step at the given knobs (see the module
    docstring).  ``use_pallas``/``attend_kernel`` pick the route;
    ``loss_mode``/``variety_n`` the objective."""
    dev = resolve_device(device)
    cfg, step_fn, xy, mask = _setup(batch_size, remat, n_max, use_pallas, attend_kernel,
                                    loss_mode, variety_n, dev)
    step = 0
    for _ in range(max(warmup, 1)):
        step_fn(xy, mask, step)
        step += 1
    launches = {k: c for k, c in count_launches(lambda: step_fn(xy, mask, step), dev).items()
                if c}
    step += 1
    if min_seconds:
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(3):
            step_fn(xy, mask, step)
            step += 1
        sync(dev)
        iters = max(iters, int(min_seconds * 3 / (time.perf_counter() - t0)) + 1)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        loss = step_fn(xy, mask, step)
        step += 1
    float(loss)  # waits for the device
    sps = iters / (time.perf_counter() - t0)

    flops_step = None
    if flops:
        _, plain_step, pxy, pmask = _setup(batch_size, remat, n_max, False, "xla", loss_mode,
                                           variety_n, dev)
        flops_step = count_flops(lambda: plain_step(pxy, pmask, 0))
    mfu = flops_step * sps / F32_PEAK if (flops_step and dev.type == "cuda") else None
    route = "pallas" if use_pallas else (f"attend={attend_kernel}" if attend_kernel else "plain")
    return TrainBenchResult(batch_size, route, loss_mode, remat, sps, sps * batch_size,
                            flops_step, mfu, launches,
                            torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")


def profile_train_step(batch_size: int = 16, n_max: int = 64, use_pallas: bool = False,
                       loss_mode: str = "nll", variety_n: int = 8, device="cuda",
                       steps: int = 3) -> dict:
    """Where a step's time goes on the card: median host enqueue and wall
    time of 10 steps, then under ``torch.profiler`` over ``steps`` steps the
    device time by kernel, the device's busy share of the wall time (one
    stream, so kernel times add) and kernels a step."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    _, step_fn, xy, mask = _setup(batch_size, True, n_max, use_pallas, None, loss_mode,
                                  variety_n, dev)
    for s in range(3):
        step_fn(xy, mask, s)
    sync(dev)
    walls, enqueue = [], []
    for s in range(10):
        t0 = time.perf_counter()
        step_fn(xy, mask, 3 + s)
        enqueue.append((time.perf_counter() - t0) * 1e3)
        sync(dev)
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s in range(steps):
            step_fn(xy, mask, 13 + s)
        sync(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    by_kernel, kernels = defaultdict(float), 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.name] += evt.time_range.elapsed_us()
            kernels += 1
    busy_us = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {"route": "pallas" if use_pallas else "plain", "loss": loss_mode,
            "batch": batch_size, "n_max": n_max,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "step_ms": statistics.median(walls), "host_enqueue_ms": statistics.median(enqueue),
            "device_kernels_per_step": kernels / steps,
            "device_busy_share": busy_us / wall_us if busy_us else None,
            "top_kernels_ms_per_step": [[k[:80], v / steps / 1e3] for k, v in top]}


def _fmt(r: TrainBenchResult) -> str:
    fl = f"{r.flops_per_step / 1e9:8.2f} GF" if r.flops_per_step else "     n/a"
    mfu = f"{100 * r.mfu:6.2f}%" if r.mfu is not None else "   n/a"
    return (f"B={r.batch_size:<5d} route={r.route:<8s} loss={r.loss:<8s} remat={r.remat!s:<5s} "
            f"{r.steps_per_sec:7.2f} steps/s  {r.windows_per_sec:9,.1f} windows/s  {fl}/step  "
            f"MFU {mfu}  launches a step {r.launches_per_step}  ({r.device})")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--min-seconds", type=float, default=3.0)
    ap.add_argument("--n-max", type=int, default=64)
    ap.add_argument("--use-pallas", action="store_true", help="the GAT kernel in every GAT call")
    ap.add_argument("--attend-kernel", default=None, choices=("auto", "xla", "pallas"))
    ap.add_argument("--loss", default="nll", choices=("nll", "variety", "hybrid"))
    ap.add_argument("--variety-n", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--profile", action="store_true",
                    help="print where a step's time goes (torch.profiler) as one JSON line")
    args = ap.parse_args(argv)
    if args.profile:
        print(json.dumps(profile_train_step(args.batch, args.n_max, args.use_pallas, args.loss,
                                            args.variety_n, args.device)))
        return
    r = bench_train_step(args.batch, not args.no_remat, args.n_max, args.iters,
                         use_pallas=args.use_pallas, attend_kernel=args.attend_kernel,
                         min_seconds=args.min_seconds, loss_mode=args.loss,
                         variety_n=args.variety_n, device=args.device)
    print(_fmt(r))


if __name__ == "__main__":
    main()
