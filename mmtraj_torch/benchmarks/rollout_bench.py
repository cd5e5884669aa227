"""Dense-crowd rollout benchmarks (counterpart of
``mmtraj/benchmarks/rollout_bench.py``).

* ``--end-to-end``: config-4 encode + K=20 sampled rollouts at a chosen graph
  size (``--n-max``, default 128), attend backend (``--kernel``) and encoder
  family (``--encoder``); window-rollouts/s on the host clock.
* ``--op-sweep``: the attend chain alone, plain (``attend_math``) against
  the Hopper kernel (``attend``) and the lane-packed kernel
  (``attend(packed=True)``, where 2N <= 128), across (N, B); CUDA-event
  times a call.

Both run on the card unless ``--device cpu`` is given; a CPU run times
PyTorch's CPU kernels and says nothing of the card.

Run:  python -m mmtraj_torch.benchmarks.rollout_bench --end-to-end --encoder attn
      python -m mmtraj_torch.benchmarks.rollout_bench --op-sweep
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from mmtraj_torch.config import config4
from mmtraj_torch.data.transforms import NormStats
from mmtraj_torch.models.forecaster import Forecaster, resolve_device
from mmtraj_torch.ops.fused_attend import attend, attend_math


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def crowd_inputs(batch: int, n_max: int, obs_len: int, device):
    """The benchmark's windows, from numpy seed 0: random-walk positions
    (steps of std 0.4 m around a start of std 5 m) and 75% of the agents
    valid -> (xy_obs (batch, n_max, obs_len, 2), mask (batch, n_max)) on
    ``device``."""
    rng = np.random.default_rng(0)
    steps = rng.normal(size=(batch, n_max, obs_len, 2)).astype(np.float32)
    xy = np.cumsum(steps * 0.4, axis=2) + rng.normal(size=(batch, n_max, 1, 2)) * 5
    xy_obs = torch.tensor(xy, dtype=torch.float32, device=device)
    mask = torch.tensor(rng.random((batch, n_max)) < 0.75, device=device)
    return xy_obs, mask


def bench_rollout(n_max: int = 128, kernel: str = "auto", batch: int = 12, k: int = 20,
                  iters: int = 100, verbose: bool = True, encoder: str = "rnn",
                  device="cuda") -> float:
    """End-to-end window-rollouts/s at (n_max, kernel, batch); K folded in.

    Inputs as the JAX package makes them: numpy seed 0, stats mean 0 and std
    0.4, 75% of the agents valid, random weights from seed 0.  Each of the
    ``iters`` calls of ``rollout_k`` perturbs the input by a uniform draw of
    at most 1e-6 and adds the output's mean into a sum that is read at the
    end.  Best of 3 timed trials after a warm-up one."""
    dev = resolve_device(device)
    cfg = config4()
    mc = dataclasses.replace(cfg.model, scan_unroll=12, attend_kernel=kernel, encoder=encoder)
    model = Forecaster(mc, cfg.data.obs_len, cfg.data.pred_len, device=dev,
                       generator=torch.Generator().manual_seed(0))
    stats = NormStats(torch.zeros(2, device=dev), torch.full((2,), 0.4, device=dev))
    xy_obs, mask = crowd_inputs(batch, n_max, cfg.data.obs_len, dev)

    def many(seed: int) -> float:
        gen = torch.Generator(device=dev).manual_seed(seed)
        acc = torch.zeros((), device=dev)
        for _ in range(iters):
            xk = xy_obs + torch.rand((), generator=gen, device=dev) * 1e-6
            acc += model.rollout_k(xk, mask, stats, k, generator=gen).mean()
        return float(acc)

    t0 = time.perf_counter()
    many(1)
    first_s = time.perf_counter() - t0
    times = []
    for trial in range(3):
        _sync(dev)
        t0 = time.perf_counter()
        many(trial)
        times.append(time.perf_counter() - t0)
    rps = batch * k * iters / min(times)
    if verbose:
        print(f"encoder={encoder} kernel={kernel:6s} N={n_max} B={batch} K={k}: {rps:10,.0f} "
              f"window-rollouts/s (warm-up run {first_s:.1f}s)", flush=True)
    return rps


def _time_us(fn, iters: int, device: torch.device) -> float:
    """Microseconds a call: best of 3 runs of ``iters`` calls after a warm-up
    call; CUDA events on the card, the host clock on the CPU."""
    fn()
    _sync(device)
    best = float("inf")
    for _ in range(3):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms * 1e3 / iters)
    return best


def op_sweep(num_heads: int = 4, dh: int = 16, iters: int = 200, device="cuda",
             ns=(64, 128, 256), bs=(256, 512, 1280)) -> list:
    """The plain attend chain against the Hopper kernels across (N, B).

    Inputs from numpy seed 0: v, s_src, s_dst normal, a dense 0/1 attend
    tile (70% edges).  Prints one line a shape, with the plain-over-kernel
    ratios, and returns one dict a shape with the times a call in
    microseconds (``packed_us`` None where 2N > 128)."""
    dev = resolve_device(device)
    H = num_heads
    rows = []
    for N in ns:
        for B in bs:
            rng = np.random.default_rng(0)
            v, ss, sd = (torch.tensor(rng.normal(size=s), dtype=torch.float32, device=dev)
                         for s in ((B, N, H * dh), (B, N, H), (B, N, H)))
            att = torch.tensor(rng.random((B, N, N)) > 0.3, dtype=torch.float32, device=dev)
            row = {"N": N, "B": B,
                   "plain_us": _time_us(lambda: attend_math(v, ss, sd, att, H), iters, dev),
                   "attend_us": _time_us(lambda: attend(v, ss, sd, att, H), iters, dev),
                   "packed_us": None}
            line = (f"N={N:4d} B={B:5d}  plain {row['plain_us']:9.1f} us | "
                    f"attend {row['attend_us']:8.1f} us {row['plain_us'] / row['attend_us']:5.2f}x")
            if 2 * N <= 128:
                row["packed_us"] = _time_us(lambda: attend(v, ss, sd, att, H, 8, True), iters, dev)
                line += (f" | packed {row['packed_us']:8.1f} us "
                         f"{row['plain_us'] / row['packed_us']:5.2f}x")
            print(line, flush=True)
            rows.append(row)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--end-to-end", action="store_true")
    ap.add_argument("--op-sweep", action="store_true")
    ap.add_argument("--n-max", type=int, default=128)
    ap.add_argument("--batch", type=int, default=12)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--kernel", default=None, choices=("auto", "xla", "pallas"),
                    help="end-to-end attend backend; default compares xla AND pallas")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--encoder", default="rnn", choices=("rnn", "attn"),
                    help="observation-encoder family for --end-to-end")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}",
          flush=True)
    if args.op_sweep:
        op_sweep(device=dev)
    if args.end_to_end or not args.op_sweep:
        kernels = (args.kernel,) if args.kernel else ("xla", "pallas")
        for kr in kernels:
            bench_rollout(args.n_max, kr, args.batch, args.k, args.iters,
                          encoder=args.encoder, device=dev)


if __name__ == "__main__":
    main()
