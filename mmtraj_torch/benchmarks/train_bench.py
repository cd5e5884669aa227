"""Training-step benchmark: steps/s, windows/s, counted FLOPs and MFU on one
GPU (counterpart of ``mmtraj/benchmarks/train_bench.py``).

It times the step ``mmtraj_torch.train`` runs (``make_train_step``: draws,
objective, backward, clipped AdamW) on config 4 at full width with random
windows, or with ``--steps-per-dispatch M`` the chunked step
(``make_multi_train_step``: on the card one step captured as a CUDA graph
and replayed M times a chunk), and reports:

- steps/s and windows/s, on the host clock around ``iters`` steps closed by
  a synchronize (``iters`` sized to last ``min_seconds``; chunks of M steps
  under ``--steps-per-dispatch``, each step on the same batch);
- the run's peak device memory: ``torch.cuda.max_memory_allocated`` above
  what was allocated when it began (after a collection, so that the memory
  of earlier runs' graphs is freed): the model, optimizer, batch, the
  step's activations and, in chunks, the graph's pool;
- FLOPs a step, counted by ``torch.utils.flop_counter.FlopCounterMode`` over
  one eager step (forward and backward, the checkpoint recomputation
  included) of the plain route in float32 at the same shape: the kernels do
  the same products, and so does bf16, so the count is the same work
  whatever implements it;
- ``mfu`` against the H100's 67 TFLOP/s float32 peak outside the tensor
  cores (on the card only), for bf16 too: its products multiply operands
  rounded to bf16 as float32 products (``models/layers.matmul``), not on
  the tensor cores;
- each kernel's launches in one step (of a chunk: the launches of the
  graph's capture, which every replay repeats; the wrappers count Python
  calls, so a replay adds nothing to their counters);
- with ``--profile``, where a step's time goes under ``torch.profiler``: the
  host's enqueue time, the device's busy share, kernels a step and the
  largest device times (of the graphed step under ``--steps-per-dispatch``).

``--encoder attn``, ``--cell lstm``, ``--remat-policy`` (``--no-remat``) and
``--dtype bfloat16`` change the model from config 4's.

Run:  python -m mmtraj_torch.benchmarks.train_bench --batch 16 --use-pallas
      python -m mmtraj_torch.benchmarks.train_bench --batch 16 --steps-per-dispatch 10
      python -m mmtraj_torch.benchmarks.train_bench --loss variety --profile
      python -m mmtraj_torch.benchmarks.train_bench --batch 16 --dtype bfloat16
      python -m mmtraj_torch.benchmarks.train_bench --device cpu --batch 2 --n-max 8 --iters 2
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import math
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
from mmtraj_torch.train import make_multi_train_step, make_optimizer, make_train_step


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
    steps_per_dispatch: int = 1
    model: str = ""  # what differs from config 4's model: encoder, cell, remat policy
    peak_mem_bytes: Optional[int] = None  # the run's own peak (module docstring); card only


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


def _model_name(remat: bool, model_kw: Optional[dict]) -> str:
    kw = {**(model_kw or {}), **({} if remat else {"remat": False})}
    return ",".join(f"{k}={v}" for k, v in sorted(kw.items())) or "config4"


def _setup(batch_size, remat, n_max, use_pallas, attend_kernel, loss_mode, variety_n, dev,
           model_kw=None, steps_per_dispatch=1):
    """-> (cfg, run, xy, mask): ``run(step)`` trains ``steps_per_dispatch``
    steps from step id ``step`` on one random batch and returns the last
    loss (the chunk's losses under ``steps_per_dispatch > 1``)."""
    cfg = config4()
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, remat=remat, use_pallas=use_pallas,
                                  **({"attend_kernel": attend_kernel} if attend_kernel else {}),
                                  **(model_kw or {})),
        train=dataclasses.replace(cfg.train, batch_size=batch_size))
    model = Forecaster(cfg.model, cfg.data.obs_len, cfg.data.pred_len, device=dev,
                       state=init_params(cfg.model, torch.Generator().manual_seed(0)))
    stats = NormStats(np.zeros(2, np.float32), np.ones(2, np.float32))
    xy, mask = fake_batch(batch_size, n_max, cfg.data.obs_len + cfg.data.pred_len, dev)
    kw = dict(loss_mode=loss_mode, variety_n=variety_n)
    if steps_per_dispatch == 1:
        step_fn = make_train_step(model, make_optimizer(cfg, model), stats, **kw)
        run = functools.partial(step_fn, xy, mask)
    else:
        multi = make_multi_train_step(model, make_optimizer(cfg, model), stats, **kw)
        idx = np.tile(np.arange(batch_size), (steps_per_dispatch, 1))

        def run(step):
            return multi(xy, mask, idx, range(step, step + steps_per_dispatch))

        run.multi = multi
    return cfg, run, xy, mask


def bench_train_step(batch_size: int = 128, remat: bool = True, n_max: int = 64,
                     iters: int = 30, warmup: int = 3, use_pallas: bool = False,
                     attend_kernel: Optional[str] = None, min_seconds: float = 3.0,
                     loss_mode: str = "nll", variety_n: int = 8, device="cuda",
                     flops: bool = True, steps_per_dispatch: int = 1,
                     model_kw: Optional[dict] = None) -> TrainBenchResult:
    """Time the config-4 training step at the given knobs (see the module
    docstring).  ``use_pallas``/``attend_kernel`` pick the route;
    ``loss_mode``/``variety_n`` the objective; ``steps_per_dispatch`` the
    chunk (one dispatch, a graph replayed, for M steps); ``model_kw``
    further ``ModelConfig`` fields (``encoder``, ``cell``,
    ``remat_policy``, ``dtype``)."""
    dev = resolve_device(device)
    M = steps_per_dispatch
    if dev.type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    cfg, run, xy, mask = _setup(batch_size, remat, n_max, use_pallas, attend_kernel, loss_mode,
                                variety_n, dev, model_kw, M)
    step = 0
    for _ in range(max(warmup // M, 1)):
        run(step)
        step += M
    if M > 1 and dev.type == "cuda":  # every replay launches what the capture launched
        launches = run.multi.capture_launches
    else:
        launches = {k: c // M for k, c in count_launches(lambda: run(step), dev).items()}
        step += M
    launches = {k: c for k, c in launches.items() if c}
    if min_seconds:
        n_cal = max(3 // M, 1)
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(n_cal):
            run(step)
            step += M
        sync(dev)
        iters = max(iters, int(min_seconds * n_cal * M / (time.perf_counter() - t0)) + 1)
    chunks = max(1, math.ceil(iters / M))
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(chunks):
        loss = run(step)
        step += M
    loss.cpu()  # waits for the device
    sps = chunks * M / (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev) - base if dev.type == "cuda" else None

    flops_step = None
    if flops:
        f32_kw = {k: v for k, v in (model_kw or {}).items() if k != "dtype"}
        _, plain_step, _, _ = _setup(batch_size, remat, n_max, False, "xla", loss_mode,
                                     variety_n, dev, f32_kw)
        flops_step = count_flops(lambda: plain_step(0))
    mfu = flops_step * sps / F32_PEAK if (flops_step and dev.type == "cuda") else None
    route = "pallas" if use_pallas else (f"attend={attend_kernel}" if attend_kernel else "plain")
    return TrainBenchResult(batch_size, route, loss_mode, remat, sps, sps * batch_size,
                            flops_step, mfu, launches,
                            torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                            M, _model_name(remat, model_kw), peak)


def profile_train_step(batch_size: int = 16, n_max: int = 64, use_pallas: bool = False,
                       loss_mode: str = "nll", variety_n: int = 8, device="cuda",
                       steps: int = 3, steps_per_dispatch: int = 1,
                       model_kw: Optional[dict] = None) -> dict:
    """Where a step's time goes on the card: median host enqueue and wall
    time a step over 10 steps (chunks of ``steps_per_dispatch``, each
    enqueued and then waited for), then under ``torch.profiler`` over
    ``steps`` steps (chunks) the device time by kernel, the device's busy
    share of the wall time (one stream, so kernel times add) and kernels a
    step.  A graphed step's kernels are the replays' (None where the
    profiler sees none)."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    M = steps_per_dispatch
    _, run, _, _ = _setup(batch_size, True, n_max, use_pallas, None, loss_mode, variety_n, dev,
                          model_kw, M)
    step = 0
    for _ in range(max(3 // M, 1)):
        run(step)
        step += M
    sync(dev)
    walls, enqueue = [], []
    for _ in range(max(10 // M, 1)):
        t0 = time.perf_counter()
        run(step)
        step += M
        enqueue.append((time.perf_counter() - t0) * 1e3 / M)
        sync(dev)
        walls.append((time.perf_counter() - t0) * 1e3 / M)
    n = max(steps // M, 1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run(step)
            step += M
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
            "batch": batch_size, "n_max": n_max, "steps_per_dispatch": M,
            "model": _model_name(True, model_kw),
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "step_ms": statistics.median(walls), "host_enqueue_ms": statistics.median(enqueue),
            "device_kernels_per_step": kernels / (n * M) if kernels else None,
            "device_busy_share": busy_us / wall_us if busy_us else None,
            "top_kernels_ms_per_step": [[k[:80], v / (n * M) / 1e3] for k, v in top]}


def _fmt(r: TrainBenchResult) -> str:
    fl = f"{r.flops_per_step / 1e9:8.2f} GF" if r.flops_per_step else "     n/a"
    mfu = f"{100 * r.mfu:6.2f}% of f32 peak" if r.mfu is not None else "   n/a"
    mem = f"{r.peak_mem_bytes / 2**20:9.1f} MiB" if r.peak_mem_bytes is not None else "      n/a"
    return (f"B={r.batch_size:<5d} route={r.route:<8s} loss={r.loss:<8s} remat={r.remat!s:<5s} "
            f"M={r.steps_per_dispatch:<3d} model={r.model} "
            f"{r.steps_per_sec:7.2f} steps/s  {r.windows_per_sec:9,.1f} windows/s  {fl}/step  "
            f"MFU {mfu}  peak {mem}  launches a step {r.launches_per_step}  ({r.device})")


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
    ap.add_argument("--steps-per-dispatch", type=int, default=1,
                    help="M steps a dispatch: one step as a CUDA graph, replayed M times")
    ap.add_argument("--encoder", default=None, choices=("rnn", "attn"))
    ap.add_argument("--cell", default=None, choices=("gru", "lstm"))
    ap.add_argument("--remat-policy", default=None, choices=("full", "dots", "dots_no_batch"))
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"),
                    help="the products' operand dtype (ModelConfig.dtype); MFU stays against "
                         "the float32 peak")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--profile", action="store_true",
                    help="print where a step's time goes (torch.profiler) as one JSON line")
    args = ap.parse_args(argv)
    model_kw = {k: v for k, v in (("encoder", args.encoder), ("cell", args.cell),
                                  ("remat_policy", args.remat_policy)) if v is not None}
    if args.dtype != "float32":
        model_kw["dtype"] = args.dtype
    if args.profile:
        print(json.dumps(profile_train_step(args.batch, args.n_max, args.use_pallas, args.loss,
                                            args.variety_n, args.device,
                                            steps_per_dispatch=args.steps_per_dispatch,
                                            model_kw=model_kw)))
        return
    r = bench_train_step(args.batch, not args.no_remat, args.n_max, args.iters,
                         use_pallas=args.use_pallas, attend_kernel=args.attend_kernel,
                         min_seconds=args.min_seconds, loss_mode=args.loss,
                         variety_n=args.variety_n, device=args.device,
                         steps_per_dispatch=args.steps_per_dispatch, model_kw=model_kw)
    print(_fmt(r))


if __name__ == "__main__":
    main()
