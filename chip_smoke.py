#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mmtraj_torch) on one NVIDIA GPU.

Runs config-4 K=20 rollout inference at full width (hidden = embed = 64,
4 heads, M = 5, N_max = 64, obs 8, pred 12) on the bench shapes of the JAX
package (B = 25 windows, inputs from numpy with seed 0, random weights from
seed 0), through the port's own entry point ``Forecaster.rollout_k``:

1. versions, and the card's name and power limit from nvidia-smi;
2. build the three CUDA kernels from ``mmtraj_torch/csrc`` (one nvcc each,
   all started together);
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, with CUDA-event timings of both;
4. route A (whole-layer GAT kernel in the encoder, the fused rollout kernel
   in the decoder) end to end, with its launch counts, against the plain
   route on the same random stream;
5. route B (the attend kernel in every GAT call) the same way;
6. one JSON line with every kernel's launches, error, times and bound.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check raises and exits nonzero; without a CUDA device the script
exits 1 before doing anything.  Usage: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np

B, N, TO, TP, K = 25, 64, 8, 12, 20
F32_PEAK = 67e12  # H100 SXM float32 FLOP/s outside the tensor cores (data sheet)
HBM_RATE = 3.35e12  # H100 SXM device-memory bytes/s (data sheet)
KERNEL_TOL = 1e-4  # attend and GAT: atol = rtol
ROLLOUT_TOL = 1e-3  # meters, on valid agents
MAX_DIVERGED = 0.01  # share of (window, sample) rollouts allowed past ROLLOUT_TOL


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 11, inner: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls,
    from CUDA events, after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound(flops: float, nbytes: float):
    """The least time the card could take: the larger of bytes over the memory
    rate and f32 operations over the f32 peak.  -> (ms, "bytes"|"operations")."""
    t_bytes, t_ops = nbytes / HBM_RATE, flops / F32_PEAK
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def attend_cost(b, n, hd, h):
    """Each input read once, the output written once; per graph 2 N^2 HD for
    the aggregate, 7 H N^2 for the chain, N HD for the division."""
    flops = b * (2 * n * n * hd + 7 * h * n * n + n * hd)
    nbytes = 4 * (2 * b * n * hd + 2 * b * n * h + b * n * n)
    return flops, nbytes


def gat_cost(b, n, d, hd, h, dout):
    flops = b * (2 * n * d * hd + 4 * n * hd + 2 * n * n * hd + 7 * h * n * n + n * hd
                 + 2 * n * hd * dout + n * dout)
    weights = d * hd + 2 * hd + hd * dout + dout
    nbytes = 4 * (b * n * d + b * n * n + b * n * dout + weights)
    return flops, nbytes


def decode_cost(b, t, n, hd_, e, hd, h, m, n_weights):
    """Per agent and step: head, sampling, embed, GRU, value and score
    products, adjacency, attend chain, output product and residual."""
    per = (2 * hd_ * 6 * m + 6 * m + 40
           + 2 * 2 * e + 2 * e
           + 2 * (e + hd_) * 3 * hd_ + 3 * hd_ + 12 * hd_
           + 2 * hd_ * hd + 4 * hd
           + 8 * n
           + 2 * n * hd + 7 * h * n + hd
           + 2 * hd * hd_ + 3 * hd_)
    flops = b * t * n * per
    nbytes = 4 * (b * n * hd_ + 2 * b * n + b * n + b * t * n * m + b * t * n * 2
                  + n_weights + b * t * n * 2)
    return flops, nbytes


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    from mmtraj_torch.config import config4
    from mmtraj_torch.data.transforms import NormStats
    from mmtraj_torch.graph.adjacency import proximity_adjacency
    from mmtraj_torch.metrics import best_of_k
    from mmtraj_torch.models.forecaster import Forecaster
    from mmtraj_torch.ops import _build, fused_attend, fused_decoder, fused_gat

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. versions and the card ---------------------------------------------
    card = gpu_line()
    log(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"device {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")
    log(card)

    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    secs = _build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s wall; per kernel "
        + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items()))
    for name in _build.KERNELS:
        for line in (_build.BUILD / f"{name}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # -- inputs, as bench.py makes them ------------------------------------------
    cfg = config4()
    plain_cfg = dataclasses.replace(cfg.model, use_pallas=False, attend_kernel="xla",
                                    use_fused_decoder=False)
    route_a = dataclasses.replace(plain_cfg, use_pallas=True, use_fused_decoder=True)
    route_b = dataclasses.replace(plain_cfg, attend_kernel="pallas")
    plain = Forecaster(plain_cfg, TO, TP, device=dev, generator=torch.Generator().manual_seed(0))
    state = plain.state_dict()
    # On the device once, as a serving loop holds them: numpy stats would be
    # copied from host memory, which waits for the stream, on every call.
    stats = NormStats(torch.zeros(2, device=dev), torch.full((2,), 0.4, device=dev))
    rng = np.random.default_rng(0)
    steps = rng.normal(size=(B, N, TO + TP, 2)).astype(np.float32) * 0.4
    xy = np.cumsum(steps, axis=2) + rng.normal(size=(B, N, 1, 2)).astype(np.float32) * 5
    xy_obs = torch.tensor(xy[:, :, :TO], dtype=torch.float32, device=dev)
    gt = torch.tensor(xy[:, :, TO:], dtype=torch.float32, device=dev)
    mask = torch.tensor(rng.random((B, N)) < 0.75, device=dev)
    log(f"shapes: B={B} N={N} obs={TO} pred={TP} K={K}; valid agents {int(mask.sum())}")

    # -- 3. each kernel against its plain version, at the main path's shapes -----
    p = plain.params()
    carry = plain.encode(xy_obs, mask, stats)
    H = cfg.model.num_heads
    results = {}

    def with_self_loops(adj, m):
        eye = torch.eye(N, dtype=torch.bool, device=dev)
        return (adj | (eye & m[:, None, :] & m[:, :, None])).float().contiguous()

    def tile(a):
        return a.repeat((K,) + (1,) * (a.ndim - 1)).contiguous()

    # attend at (B*K, N, HD): decoder GAT inputs from the encoder's state.
    g = p["dec"]["gat"]
    hk, mk, xyk = tile(carry.h), tile(mask), tile(xy_obs[:, :, -1])
    v = (hk @ g["wv"]).contiguous()
    s_src = (v @ fused_gat._block_diag(g["a_src"])).contiguous()
    s_dst = (v @ fused_gat._block_diag(g["a_dst"])).contiguous()
    att = with_self_loops(proximity_adjacency(xyk, mk, cfg.model.adjacency_radius), mk)
    out_k = fused_attend.attend(v, s_src, s_dst, att, H)
    out_p = fused_attend.attend_math(v, s_src, s_dst, att, H)
    torch.cuda.synchronize()
    err = (out_k - out_p).abs().max().item()
    check(torch.allclose(out_k, out_p, atol=KERNEL_TOL, rtol=KERNEL_TOL),
          f"attend kernel vs plain: max abs err {err}")
    results["attend"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: fused_attend.attend(v, s_src, s_dst, att, H)),
        plain_ms=time_ms(torch, lambda: fused_attend.attend_math(v, s_src, s_dst, att, H)),
        cost=attend_cost(B * K, N, v.shape[-1], H))
    log(f"attend {tuple(v.shape)} H={H}: max abs err {err:.3e} (tol {KERNEL_TOL}); "
        f"kernel {results['attend']['ms']:.4f} ms, plain {results['attend']['plain_ms']:.4f} ms; "
        f"edges {int(att.sum())} of {att.numel()}")

    # fused_gat at (B, N, D): the encoder GAT on the last observed frame.
    g = p["enc"]["gat"]
    h = carry.h.contiguous()
    att = with_self_loops(proximity_adjacency(xy_obs[:, :, -1], mask,
                                              cfg.model.adjacency_radius), mask)
    gat_args = (h, att, g["wv"], g["a_src"], g["a_dst"], g["wo"], g["bo"], H)
    out_k = fused_gat.fused_gat(*gat_args)
    out_p = fused_gat.gat_math(*gat_args)
    torch.cuda.synchronize()
    err = (out_k - out_p).abs().max().item()
    check(torch.allclose(out_k, out_p, atol=KERNEL_TOL, rtol=KERNEL_TOL),
          f"fused_gat kernel vs plain: max abs err {err}")
    results["fused_gat"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: fused_gat.fused_gat(*gat_args)),
        plain_ms=time_ms(torch, lambda: fused_gat.gat_math(*gat_args)),
        cost=gat_cost(B, N, h.shape[-1], g["wv"].shape[1], H, g["wo"].shape[1]))
    log(f"fused_gat {tuple(h.shape)} H={H}: max abs err {err:.3e} (tol {KERNEL_TOL}); "
        f"kernel {results['fused_gat']['ms']:.4f} ms, plain {results['fused_gat']['plain_ms']:.4f} ms")

    # fused_decode at B*K rollout graphs, on a stream drawn on the card.
    M = cfg.model.num_mixtures
    gumbel, normal = plain._rollout_stream(B * K, N, torch.Generator(device=dev).manual_seed(2))
    hw, hb = fused_decoder.permute_head(p["head"]["w"], p["head"]["b"], M)
    dec_kw = dict(num_heads=H, num_mixtures=M, radius=cfg.model.adjacency_radius,
                  sigma_min=cfg.model.sigma_min, rho_max=cfg.model.rho_max,
                  stats_mean=stats.mean, stats_std=stats.std)
    dec_args = (hk, xyk, mk, gumbel, normal, p["dec"], hw, hb)
    out_k = fused_decoder.fused_decode(*dec_args, **dec_kw)
    out_p = fused_decoder.reference_decode(*dec_args, **dec_kw)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out_k).all()), "fused_decode output is not finite")
    valid = mk[:, None, :, None].expand_as(out_k)
    diff = torch.where(valid, (out_k - out_p).abs(), 0.0)
    per_graph = diff.flatten(1).amax(1)
    diverged = int((per_graph > ROLLOUT_TOL).sum())
    err = per_graph[per_graph <= ROLLOUT_TOL].max().item()
    check(diverged <= MAX_DIVERGED * B * K,
          f"fused_decode: {diverged} of {B * K} rollouts past {ROLLOUT_TOL} m")
    n_weights = sum(t.numel() for t in (*(x for d in p["dec"].values() if isinstance(d, dict)
                                            for x in d.values()), hw, hb))
    results["fused_decode"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: fused_decoder.fused_decode(*dec_args, **dec_kw), inner=2),
        plain_ms=time_ms(torch, lambda: fused_decoder.reference_decode(*dec_args, **dec_kw),
                         reps=5, inner=1),
        cost=decode_cost(B * K, TP, N, cfg.model.hidden_dim, cfg.model.embed_dim,
                         g["wv"].shape[1], H, M, n_weights))
    log(f"fused_decode (Bk={B * K}, T={TP}, N={N}): max abs err {err:.3e} m on valid agents "
        f"of the rollouts within tol {ROLLOUT_TOL}; {diverged} of {B * K} rollouts past it; "
        f"kernel {results['fused_decode']['ms']:.4f} ms, "
        f"plain {results['fused_decode']['plain_ms']:.4f} ms")

    # -- 4./5. the routes end to end, through Forecaster.rollout_k -----------------
    counters = {"attend": fused_attend.attend, "fused_gat": fused_gat.fused_gat,
                "fused_decode": fused_decoder.fused_decode}
    launches = {}

    def run_route(name, model_cfg, expect):
        model = Forecaster(model_cfg, TO, TP, device=dev, state=state)
        for fn in counters.values():
            fn.launches = 0
        roll = model.rollout_k(xy_obs, mask, stats, K,
                               generator=torch.Generator(device=dev).manual_seed(1))
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in counters.items()}
        check(counts == expect, f"route {name}: launches {counts}, expected {expect}")
        launches.update({k: c for k, c in counts.items() if c})
        ref = plain.rollout_k(xy_obs, mask, stats, K,
                              generator=torch.Generator(device=dev).manual_seed(1))
        check(roll.shape == (K, B, N, TP, 2), f"route {name}: shape {tuple(roll.shape)}")
        check(bool(torch.isfinite(roll).all()), f"route {name}: output is not finite")
        d = torch.where(mask[None, :, :, None, None], (roll - ref).abs(), 0.0)
        per = d.flatten(2).amax(2)  # (K, B)
        n_bad = int((per > ROLLOUT_TOL).sum())
        check(n_bad <= MAX_DIVERGED * K * B,
              f"route {name}: {n_bad} of {K * B} rollouts past {ROLLOUT_TOL} m of the plain route")
        ade, fde = best_of_k(roll, gt, mask)
        ade_p, fde_p = best_of_k(ref, gt, mask)
        check(bool(torch.isfinite(ade) & torch.isfinite(fde)), f"route {name}: best_of_k not finite")
        iters = 10
        model.rollout_k(xy_obs, mask, stats, K)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            model.rollout_k(xy_obs, mask, stats, K)
        torch.cuda.synchronize()
        rate = B * K * iters / (time.perf_counter() - t0)
        log(f"route {name}: launches {counts}; max abs err vs plain "
            f"{per[per <= ROLLOUT_TOL].max().item():.3e} m, {n_bad} of {K * B} rollouts past "
            f"{ROLLOUT_TOL} m; best-of-{K} ADE/FDE {ade.item():.4f}/{fde.item():.4f} m "
            f"(plain {ade_p.item():.4f}/{fde_p.item():.4f}); {rate:.1f} window-rollouts/s")
        return rate

    rate_a = run_route("A", route_a, {"attend": 0, "fused_gat": TO, "fused_decode": 1})
    rate_b = run_route("B", route_b, {"attend": TO + TP, "fused_gat": 0, "fused_decode": 0})
    rate_p = run_route("plain", plain_cfg, {"attend": 0, "fused_gat": 0, "fused_decode": 0})
    log(f"window-rollouts/s (K={K}, B={B}, N={N}): route A {rate_a:.1f}, route B {rate_b:.1f}, "
        f"plain {rate_p:.1f}")

    # -- 6. the kernels line ----------------------------------------------------
    sources = {
        "attend": ("mmtraj_torch/csrc/attend.cu", "mmtraj/ops/fused_attend.py:212"),
        "fused_gat": ("mmtraj_torch/csrc/gat.cu", "mmtraj/ops/fused_gat.py:150"),
        "fused_decode": ("mmtraj_torch/csrc/decoder.cu", "mmtraj/ops/fused_decoder.py:208"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        r = results[name]
        bound_ms, bound_by = bound(*r["cost"])
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches.get(name, 0), "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
