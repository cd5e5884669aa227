"""The padding tax, measured on the card (counterpart of
``mmtraj/benchmarks/occupancy_bench.py``).

A headline rate is quoted at one padded shape (N_max = 64, about 75% of the
slots valid).  Real ETH/UCY is bimodal: zara/eth/hotel windows hold about
2-12 agents, univ's 30-50+, so under one N_max = 64 a 6-agent window pays
the whole 64-slot attend chain and 64-row products.  This benchmark

1. draws agent counts from documented distributions (below);
2. times config 4's ``rollout_k`` (K = 20, random weights from seed 0) at
   each bucket capacity of ``BUCKETS``, each at the batch that ``cli eval``
   takes by default (``evaluate.vmem_friendly_batch`` for float32), as a
   CUDA graph of the whole call replayed ``iters`` times, its stream drawn
   inside the graph from the device's generator as
   ``mmtraj_torch/benchmarks/bench.py`` does (best of 3 trials); a
   workload's bucketed rate is its windows over the sum of each bucket's
   share over that bucket's rate, its padded rate the N = 64 rate;
3. with ``--evaluate-wall``, times the deployed path, ``evaluate()`` padded
   and with ``buckets=BUCKETS``, on window sets of those counts; the two
   must agree within 1e-5 m of ADE.

Routes: ``plain`` (no kernel; what the JAX bench runs) and ``A``
(``use_pallas`` and ``use_fused_decoder``: ``fused_gat`` and
``fused_decode`` at N = 16, 32 and 64).  On the card a route-A kernel that
does not build or launch raises; nothing measures plain in its place.

Agent-count distributions (approximations of the public ETH/UCY window
statistics; the windower keeps agents present for all 20 frames):

  sparse    Uniform{2..12}   (zara1/zara2/eth/hotel-like windows)
  dense     Uniform{30..50}  (univ-like windows)
  mixed     80% sparse + 20% dense (4 sparse scenes : 1 dense scene)
  synthetic the empirical counts of the synthetic five-scene test splits

Stdout is one JSON line naming the card and its power limit; the table
goes to stderr.  ``--device cpu`` runs eagerly on the CPU at any size (a CPU
rate says nothing of the card).

Run:  python -m mmtraj_torch.benchmarks.occupancy_bench [--iters 200] [--route plain|A]
      python -m mmtraj_torch.benchmarks.occupancy_bench --evaluate-wall
      python -m mmtraj_torch.benchmarks.occupancy_bench --device cpu --iters 1 --k 2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time

import numpy as np
import torch

from mmtraj_torch.benchmarks.bench import ROUTES, capture, card_line
from mmtraj_torch.benchmarks.rollout_bench import _sync as sync
from mmtraj_torch.config import SCENES, config4
from mmtraj_torch.data.transforms import NormStats
from mmtraj_torch.evaluate import _model_bytes_per_elem, vmem_friendly_batch
from mmtraj_torch.models.forecaster import Forecaster

BUCKETS = (16, 32, 64)
BENCH_ROUTES = ("plain", "A")
WORKLOADS = ("sparse", "mixed", "dense", "synthetic")
WALL_WORKLOADS = ("sparse", "mixed", "dense")
ADE_GATE = 1e-5  # meters: bucketed evaluate() against padded


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def workload_counts(name: str, n_windows: int, rng: np.random.Generator) -> np.ndarray:
    """Agent counts of ``n_windows`` windows of a documented distribution
    (module docstring)."""
    if name == "sparse":
        return rng.integers(2, 13, n_windows)
    if name == "dense":
        return rng.integers(30, 51, n_windows)
    if name == "mixed":
        sparse = rng.integers(2, 13, n_windows)
        dense = rng.integers(30, 51, n_windows)
        return np.where(rng.random(n_windows) < 0.8, sparse, dense)
    if name == "synthetic":
        from mmtraj_torch.data.registry import load_split
        from mmtraj_torch.data.synthetic import write_synthetic_dataset

        counts = []
        with tempfile.TemporaryDirectory() as d:
            write_synthetic_dataset(d, seed=0, n_frames=600)
            for scene in SCENES:
                _, test_w = load_split(d, scene, 8, 12)
                counts.extend(w.shape[0] for w in test_w)
        counts = np.asarray(counts)
        return counts[rng.integers(0, len(counts), n_windows)]
    raise ValueError(f"unknown workload {name!r}")


def make_model(route: str, device="cuda"):
    """Config 4 on ``route`` ("plain" or "A"), weights from seed 0, stats
    (0, 0.4) on the device -> (model, stats)."""
    cfg = config4()
    mc = dataclasses.replace(cfg.model, **ROUTES[route])
    model = Forecaster(mc, cfg.data.obs_len, cfg.data.pred_len, device=device,
                       generator=torch.Generator().manual_seed(0))
    stats = NormStats(torch.zeros(2, device=model.device),
                      torch.full((2,), 0.4, device=model.device))
    return model, stats


def bucket_batch(model, k: int, n_cap: int) -> int:
    """The batch ``evaluate`` runs a bucket at by default."""
    return vmem_friendly_batch(k, n_cap, bytes_per_elem=_model_bytes_per_elem(model))


def rate_inputs(model, n_cap: int, batch: int, counts: np.ndarray, rng: np.random.Generator):
    """Random-walk observations and contiguous-prefix masks with counts
    drawn from ``counts`` -> (xy_obs, mask), device tensors."""
    steps = rng.normal(size=(batch, n_cap, model.obs_len, 2)).astype(np.float32) * 0.4
    xy = np.cumsum(steps, axis=2) + rng.normal(size=(batch, n_cap, 1, 2)) * 5
    c = counts[rng.integers(0, len(counts), batch)]
    mask = np.arange(n_cap)[None, :] < np.minimum(c, n_cap)[:, None]
    return (torch.tensor(xy, dtype=torch.float32, device=model.device),
            torch.tensor(mask, device=model.device))


def measure_rate(model, stats, n_cap: int, batch: int, k: int, iters: int, counts: np.ndarray,
                 rng: np.random.Generator) -> float:
    """windows/s of ``rollout_k`` at (batch, n_cap): on the card a CUDA graph
    of the whole call replayed ``iters`` times a trial (the stream drawn
    inside it), on the CPU eager calls; best of 3 trials."""
    xy_obs, mask = rate_inputs(model, n_cap, batch, counts, rng)
    dev = model.device

    def call():
        return model.rollout_k(xy_obs, mask, stats, k)

    t0 = time.perf_counter()
    if dev.type == "cuda":
        graph, _ = capture(call, dev)
        run = graph.replay
    else:
        run = call
    run()
    sync(dev)
    log(f"    [N={n_cap} B={batch}] capture+first: {time.perf_counter() - t0:.1f}s")
    times = []
    for _ in range(3):
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        sync(dev)
        times.append(time.perf_counter() - t0)
    return batch * iters / min(times)


def run_rates(iters: int, k: int = 20, n_windows: int = 4000, route: str = "plain",
              device="cuda") -> dict:
    """The padded-against-bucketed table of every workload on ``route``."""
    model, stats = make_model(route, device)
    rng = np.random.default_rng(0)
    # A bucket's rate depends on its shape only: measured once a bucket.
    rates = {}
    for n_cap in BUCKETS:
        b = bucket_batch(model, k, n_cap)
        rates[n_cap] = (b, measure_rate(model, stats, n_cap, b, k, iters, np.array([n_cap]),
                                        rng))
        log(f"  {route} N={n_cap}: B={b} -> {rates[n_cap][1]:,.0f} windows/s")
    out = {}
    for wl in WORKLOADS:
        counts = np.minimum(workload_counts(wl, n_windows, np.random.default_rng(1)), 64)
        route_of = np.searchsorted(BUCKETS, counts, side="left")
        shares = np.bincount(route_of, minlength=len(BUCKETS)) / len(counts)
        mean_agents = counts.mean()
        padded_wps = rates[64][1]
        # A workload's rate: its windows over the sum of the buckets' time shares.
        bucket_time = sum(shares[i] / rates[nb][1] for i, nb in enumerate(BUCKETS)
                          if shares[i] > 0)
        bucketed_wps = 1.0 / bucket_time
        out[wl] = {
            "mean_agents": float(mean_agents),
            "shares": {int(nb): float(shares[i]) for i, nb in enumerate(BUCKETS)},
            "padded_wps": float(padded_wps),
            "bucketed_wps": float(bucketed_wps),
            "speedup": float(bucketed_wps / padded_wps),
            "padded_agent_tps": float(padded_wps * k * mean_agents),
            "bucketed_agent_tps": float(bucketed_wps * k * mean_agents),
        }
    return {"rates": {int(nb): {"batch": rates[nb][0], "windows_per_sec": float(rates[nb][1])}
                      for nb in BUCKETS},
            "workloads": out}


def wall_windows(name: str, n_windows: int, rng: np.random.Generator):
    """Random-walk windows (n, 20, 2) with ``name``'s agent counts, capped
    at 64 -> (windows, counts)."""
    counts = np.minimum(workload_counts(name, n_windows, rng), 64)
    windows = [np.cumsum(rng.normal(size=(int(c), 20, 2)).astype(np.float32) * 0.3, axis=1)
               for c in counts]
    return windows, counts


def run_evaluate_wall(k: int = 20, n_windows: int = 1000, route: str = "plain", device="cuda",
                      workloads=WALL_WORKLOADS) -> dict:
    """The deployed path: ``evaluate()``'s wall clock, padded and bucketed,
    on window sets of each workload's counts; a first call of each builds
    and warms it, the second is timed and must repeat the first's metrics.
    Bucketed ADE must be within ``ADE_GATE`` of padded."""
    from mmtraj_torch.data.collate import WindowDataset
    from mmtraj_torch.evaluate import evaluate

    model, stats = make_model(route, device)
    out = {}
    for wl in workloads:
        windows, counts = wall_windows(wl, n_windows, np.random.default_rng(2))
        ds = WindowDataset(windows, n_max=64)
        res = {}
        for mode, kw in (("padded", {}), ("bucketed", {"buckets": BUCKETS})):
            m0 = evaluate(model, stats, ds, k=k, seed=0, **kw)
            sync(model.device)
            t0 = time.perf_counter()
            m1 = evaluate(model, stats, ds, k=k, seed=0, **kw)
            sync(model.device)
            dt = time.perf_counter() - t0
            if m0["min_ade"] != m1["min_ade"]:
                raise RuntimeError(f"{wl}/{mode}: evaluate() did not repeat its metrics "
                                   f"({m0['min_ade']} then {m1['min_ade']})")
            res[mode] = {"wall_s": dt, "windows_per_sec": n_windows / dt,
                         "min_ade": m1["min_ade"]}
            log(f"  {route} {wl}/{mode}: {dt:.2f}s ({n_windows / dt:,.0f} windows/s) "
                f"ade={m1['min_ade']:.6f}")
        d_ade = abs(res["padded"]["min_ade"] - res["bucketed"]["min_ade"])
        if not d_ade < ADE_GATE:
            raise RuntimeError(f"{route} {wl}: bucketed ADE {d_ade} m off padded "
                               f"(gate {ADE_GATE})")
        res["ade_delta"] = d_ade
        res["speedup"] = res["bucketed"]["windows_per_sec"] / res["padded"]["windows_per_sec"]
        res["mean_agents"] = float(counts.mean())
        out[wl] = res
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--route", choices=BENCH_ROUTES, default=None,
                    help="one route (default: plain and A)")
    ap.add_argument("--evaluate-wall", action="store_true",
                    help="also time evaluate() padded against bucketed")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    routes = (args.route,) if args.route else BENCH_ROUTES
    res = {"card": card_line() if device.type == "cuda" else "cpu", "device": str(device),
           "k": args.k, "iters": args.iters, "buckets": list(BUCKETS)}
    for route in routes:
        r = run_rates(args.iters, args.k, route=route, device=device)
        log(f"\nroute {route}: workload  mean_N  padded w/s  bucketed w/s  speedup  "
            "padded agent-traj/s  bucketed agent-traj/s")
        for wl, w in r["workloads"].items():
            log(f"{wl:14s} {w['mean_agents']:7.1f} {w['padded_wps']:11,.0f} "
                f"{w['bucketed_wps']:13,.0f} {w['speedup']:8.2f} "
                f"{w['padded_agent_tps']:20,.0f} {w['bucketed_agent_tps']:22,.0f}")
        if args.evaluate_wall:
            r["evaluate_wall"] = run_evaluate_wall(args.k, route=route, device=device)
        res[route] = r
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
