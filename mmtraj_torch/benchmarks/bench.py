"""The port's headline benchmark: window-rollouts/s at K=20 on one GPU
(counterpart of the root ``bench.py``).

The flagship model (config 4 at full width: GRU, 4-head GAT, GMM with M=5,
N_max=64, obs 8, pred 12), random weights from ``init_params`` with a
generator seeded 0, stats (0, 0.4), B=25 windows made as ``bench.py`` makes
them.  A window-rollout is one sampled 12-step future of one window, so the
value counts B*K of them a ``rollout_k`` call.

The timed program is one CUDA graph of the whole ``rollout_k`` call (encode
and the 12-step decode), replayed ``iters`` times a trial, with ``iters``
chosen so that a trial lasts at least a second; best of 5 trials, each
closed by ``torch.cuda.synchronize()``.  The graph counterparts
``bench.py``'s one compiled program: the host's per-op dispatch, which sets
every eager rate of this model on the card, is paid once at capture.  The
random stream is drawn inside the graph from the device's default
generator, which every CUDA graph registers at capture: each replay
advances its offset and draws fresh numbers, as each iteration of
``bench.py``'s scan draws from a fresh key.  Every kernel is built and run
once before any capture, and the inputs and stats are device tensors, so
nothing in the captured call copies from the host or waits for the device.

Routes plain (no kernel), A (``use_pallas`` + ``use_fused_decoder``) and B
(``attend_kernel="pallas"``), each eager and graphed, go to the log on
stderr with their launches (counted on one eager call: replays do not count
them); ``value`` is the fastest, named in ``route``.  The denominators are
copies of the JAX package's numpy loops, measured as ``bench.py`` measures
them.  FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode`` over
one eager call of the plain route (the kernels do the same products), and
``mfu_pct`` is against the H100's 67 TFLOP/s float32 peak outside the
tensor cores.

Stdout is exactly one JSON line.  Runs on the card; ``--device cpu`` runs
the eager routes on the CPU at the given ``--batch/--k/--iters`` (a CPU
rate says nothing of the card, and no MFU is given for it).

Run:  python -m mmtraj_torch.benchmarks.bench
      python -m mmtraj_torch.benchmarks.bench --device cpu --batch 2 --k 2 --n-max 8 --iters 1
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from mmtraj_torch.benchmarks.rollout_bench import _sync as sync
from mmtraj_torch.ops import launch_counters

F32_PEAK = 67e12  # H100 SXM float32 FLOP/s outside the tensor cores (data sheet)
MFU_PEAK = "f32-67TF (H100 SXM, outside the tensor cores)"
ROUTES = {
    "plain": dict(use_pallas=False, attend_kernel="xla", use_fused_decoder=False),
    "A": dict(use_pallas=True, attend_kernel="xla", use_fused_decoder=True),
    "B": dict(use_pallas=False, attend_kernel="pallas", use_fused_decoder=False),
}
TRIALS = 5


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bench_inputs(rng: np.random.Generator, B: int, N: int, obs_len: int, device):
    """``bench.py:83-86``: random-walk windows (steps of std 0.4 m from a
    start of std 5 m) and 75% of the agents valid -> (xy_obs, mask)."""
    steps = rng.normal(size=(B, N, obs_len, 2)).astype(np.float32) * 0.4
    xy = np.cumsum(steps, axis=2) + rng.normal(size=(B, N, 1, 2)) * 5
    return (torch.tensor(xy, dtype=torch.float32, device=device),
            torch.tensor(rng.random((B, N)) < 0.75, device=device))


def count_launches(fn, device) -> dict:
    """Each kernel's launches in one call of ``fn``."""
    counters = launch_counters()
    before = {k: c.launches for k, c in counters.items()}
    fn()
    sync(device)
    return {k: c.launches - before[k] for k, c in counters.items()}


def capture(fn, device, warmup: int = 3):
    """A CUDA graph of one call of ``fn`` -> (graph, its static output),
    after ``warmup`` calls on a side stream."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = fn()
    graph.replay()
    torch.cuda.synchronize(device)
    return graph, out


def graph_vs_eager(model, xy_obs, mask, stats, k: int, stream) -> float:
    """Largest difference on valid agents between ``rollout_k`` replayed
    from a CUDA graph and called eagerly, both on the pre-drawn ``stream``."""
    def call():
        return model.rollout_k(xy_obs, mask, stats, k, stream=stream)

    graph, out = capture(call, xy_obs.device)
    graph.replay()
    eager = call()
    torch.cuda.synchronize(xy_obs.device)
    return torch.where(mask[None, :, :, None, None], (out - eager).abs(), 0.0).max().item()


def best_time(fn, iters: int, device, trials: int = TRIALS):
    """-> (best seconds of ``iters`` calls over ``trials``, every trial's)."""
    times = []
    for _ in range(trials):
        sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync(device)
        times.append(time.perf_counter() - t0)
    return min(times), times


def iters_for(fn, device, min_s: float = 1.0) -> int:
    """Calls that take at least ``min_s`` seconds, from 3 timed calls."""
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    sync(device)
    per = (time.perf_counter() - t0) / 3
    return max(1, math.ceil(1.1 * min_s / per))


def count_flops(fn) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())


def host_denominators(params, cfg, stats_np, xy_obs, mask, rng, K: int, pred_len: int,
                      n_max: int, obs_len: int, host_batch: int, ref_iters: int):
    """The two numpy denominators in window-rollouts/s, measured as
    ``bench.py:163-220``: the reference-style loop on window 0's valid agents
    (min wall of ``ref_iters`` windows), and the vectorized host forecaster
    at its own batch ``host_batch`` (min of 2)."""
    from mmtraj_torch.benchmarks.reference_loop import ReferenceStyleForecaster
    from mmtraj_torch.benchmarks.vectorized_host import VectorizedHostForecaster

    args = (params, cfg.num_heads, cfg.num_mixtures, cfg.adjacency_radius, cfg.sigma_min,
            cfg.rho_max, stats_np[0], stats_np[1])
    ref = ReferenceStyleForecaster(*args)
    w_mask = mask[0].cpu().numpy()
    w_obs = xy_obs[0].cpu().numpy()[w_mask]
    nrng = np.random.default_rng(0)
    ref.rollout(w_obs[:, :2], k=1, pred_len=2, rng=nrng)  # warm caches
    per_iter, t_cpu0 = [], time.process_time()
    for _ in range(ref_iters):
        t0 = time.time()
        ref.rollout(w_obs, k=K, pred_len=pred_len, rng=nrng)
        per_iter.append(time.time() - t0)
    cpu_dt = (time.process_time() - t_cpu0) / ref_iters
    ref_rps = K / min(per_iter)
    log(f"reference-style loop: {ref_iters} windows (N={len(w_obs)}), per-window wall "
        f"{[f'{t:.2f}' for t in per_iter]}s (min {min(per_iter):.2f}, cpu {cpu_dt:.2f}) -> "
        f"{ref_rps:.2f} window-rollouts/s (cpu-time check {K / cpu_dt:.2f}/s)")

    vec = VectorizedHostForecaster(*args)
    hsteps = rng.normal(size=(host_batch, n_max, obs_len, 2)).astype(np.float32) * 0.4
    xy_np = (np.cumsum(hsteps, axis=2)
             + rng.normal(size=(host_batch, n_max, 1, 2)) * 5).astype(np.float32)
    mask_np = rng.random((host_batch, n_max)) < 0.75
    vec.rollout_batch(xy_np[:2], mask_np[:2], k=2, pred_len=2, rng=nrng)  # warm
    vec_times = []
    for _ in range(2):
        t0 = time.time()
        vec.rollout_batch(xy_np, mask_np, k=K, pred_len=pred_len, rng=nrng)
        vec_times.append(time.time() - t0)
    vec_rps = host_batch * K / min(vec_times)
    log(f"vectorized-host (NumPy, K-in-batch): {host_batch} windows x K={K} in "
        f"{min(vec_times):.2f}s -> {vec_rps:,.1f} window-rollouts/s")
    return ref_rps, vec_rps


def run(device="cuda", batch: int = 25, k: int = 20, n_max: int = 64, iters: int = None,
        host_batch: int = 64, ref_iters: int = 6) -> dict:
    """The benchmark -> its JSON record (see the module docstring)."""
    from mmtraj_torch.config import config4
    from mmtraj_torch.data.transforms import NormStats
    from mmtraj_torch.models.forecaster import Forecaster, resolve_device
    from mmtraj_torch.ops import _build
    from mmtraj_torch.params import init_params

    dev = resolve_device(device)
    on_cuda = dev.type == "cuda"
    if on_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _build.build()
    cfg = config4()
    TO, TP, B, K, N = cfg.data.obs_len, cfg.data.pred_len, batch, k, n_max
    card = card_line() if on_cuda else "cpu"
    log(f"device: {card}  B={B} N={N} obs={TO} pred={TP} K={K}")
    state = init_params(cfg.model, torch.Generator().manual_seed(0))
    stats_np = (np.zeros(2, np.float32), np.full(2, 0.4, np.float32))
    stats = NormStats(*(torch.as_tensor(a, device=dev) for a in stats_np))
    rng = np.random.default_rng(0)
    xy_obs, mask = bench_inputs(rng, B, N, TO, dev)

    rates, models = {}, {}
    for name, flags in ROUTES.items():
        model = Forecaster(dataclasses.replace(cfg.model, **flags), TO, TP, device=dev,
                           state=state)
        models[name] = model

        def eager(model=model):
            return model.rollout_k(xy_obs, mask, stats, K)

        launches = {kk: c for kk, c in count_launches(eager, dev).items() if c}
        modes = [("eager", eager)]
        if on_cuda:
            graph, _ = capture(eager, dev)
            modes.append(("graph", graph.replay))
        for mode, fn in modes:
            n = iters if iters is not None else (iters_for(fn, dev) if on_cuda else 2)
            best, times = best_time(fn, n, dev)
            rates[f"{name}-{mode}"] = B * K * n / best
            log(f"route {name} {mode}: {best / n * 1e3:.3f} ms a call (best of {TRIALS} trials "
                f"of {n}: {[f'{t:.3f}' for t in times]} s) -> {rates[f'{name}-{mode}']:,.1f} "
                f"window-rollouts/s; launches a call {launches}")
        if on_cuda:
            del graph
    route = max(rates, key=rates.get)
    value = rates[route]

    flops = count_flops(lambda: models["plain"].rollout_k(xy_obs, mask, stats, K))
    flops_ps = flops * value / (B * K)
    mfu = 100.0 * flops_ps / F32_PEAK if on_cuda else None
    log(f"FlopCounterMode, one plain call: {flops / 1e9:.3f} GFLOP -> {flops_ps / 1e12:.4f} "
        f"TFLOP/s at {route}" + (f" = {mfu:.3f}% of {MFU_PEAK}" if mfu is not None else ""))

    ref_rps, vec_rps = host_denominators(
        models["plain"].params(), cfg.model, stats_np, xy_obs, mask, rng, K, TP, N, TO,
        host_batch, ref_iters)
    return {
        "metric": "rollouts_per_sec_per_chip_k20",
        "value": round(value, 1),
        "unit": f"window-rollouts/s/chip (K={K}, N_max={N}, obs={TO}, pred={TP})",
        "vs_baseline": round(value / ref_rps, 1),
        "vs_vectorized_host": round(value / vec_rps, 1),
        "route": route,
        "device": card,
        "rates": {kk: round(v, 1) for kk, v in rates.items()},
        "tflops_per_sec": round(flops_ps / 1e12, 4),
        "mfu_pct": round(mfu, 3) if mfu is not None else None,
        "mfu_peak": MFU_PEAK,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=25)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--n-max", type=int, default=64)
    ap.add_argument("--iters", type=int, default=None,
                    help="calls a trial; default: a second's worth on the card, 2 on the CPU")
    ap.add_argument("--host-batch", type=int, default=64,
                    help="windows of the vectorized-host denominator")
    ap.add_argument("--ref-iters", type=int, default=6,
                    help="windows of the reference-loop denominator")
    args = ap.parse_args(argv)
    with torch.no_grad():
        rec = run(args.device, args.batch, args.k, args.n_max, args.iters, args.host_batch,
                  args.ref_iters)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
