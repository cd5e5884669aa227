#!/usr/bin/env python
"""Host time of one eager call of each kernel wrapper, and of one eager
route-A ``rollout_k`` call, for one checkout of this repo, so that two
checkouts can be held side by side on one card (run it once for each, in
turns, in one call).

An eager call's time on the card is set by the host when the kernel takes
less time than the wrapper's own work (checks, the launch, here the
``torch.library`` dispatch of the custom op), so this measures what a
change to the wrappers costs the host-bound paths (eager ``rollout_k``, an
exported program, a training step).  ``--root`` names the checkout whose
``mmtraj_torch`` is imported and built (default: this one).  Shapes are the
flagship's (config 4, B = 25, N = 64, K = 20): ``attend`` at (500, 64, 64),
``fused_gat`` at (25, 64, 64), ``fused_decode`` at (500, 12, 64) (whose
device time sets its call), inputs from numpy seed 0; and the two wrappers
of the training steps: ``weight_grad_lanes`` at config 3's GRU product,
(S, R, din x dout) = (5, 8192, 64 x 192) and one lane of it (S = 1, beside
cuBLAS's ``mm`` of the same product, which a sequential step takes), and
``fused_gat_grad`` at config4-attn3's frame graphs, (1,024, 64, 64) with
4 heads.  Each number is the median over 5 trials of ``CALLS`` back-to-back
calls closed by one ``torch.cuda.synchronize()``, in microseconds a call
(milliseconds for ``rollout_k``), under ``torch.no_grad()``; ``*_issue_us``
is the same trials' host time before that synchronize, what the host spends
a call where the card keeps up (a call whose kernels take longer reads its
device time in ``*_us``).

Prints the card's name and power limit, then one JSON line.  Needs a CUDA
device; exits 1 without one.  Usage:
    python tools/wrapper_dispatch.py [--root DIR]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
CALLS, TRIALS = 200, 5


def per_call(torch, fn, calls: int = CALLS):
    """Medians over TRIALS of the host seconds a call, closed by a
    synchronize and before it -> (closed, issued)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    closed, issued = [], []
    for _ in range(TRIALS):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        closed.append((time.perf_counter() - t0) / calls)
        issued.append((t1 - t0) / calls)
    return statistics.median(closed), statistics.median(issued)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("wrapper_dispatch: no CUDA device", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from mmtraj_torch.benchmarks.bench import card_line
    from mmtraj_torch.config import config4
    from mmtraj_torch.data.transforms import NormStats
    from mmtraj_torch.models.forecaster import Forecaster
    from mmtraj_torch.ops import _build, dense_grad, fused_attend, fused_decoder, fused_gat

    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(dev)

    H, W, M, T = 4, 64, 5, 12
    att = torch.from_numpy((rng.random((500, 64, 64)) < 0.08).astype(np.float32)).to(dev)
    v, s_src, s_dst = t(500, 64, W), t(500, 64, H), t(500, 64, H)
    gat_args = (t(25, 64, W), att[:25].contiguous(), t(W, W, scale=0.1), t(H, W // H),
                t(H, W // H), t(W, W, scale=0.1), t(W), H)
    cfg = config4()
    route_a = dataclasses.replace(cfg.model, use_pallas=True, use_fused_decoder=True,
                                  attend_kernel="xla")
    model = Forecaster(route_a, 8, T, device=dev, generator=torch.Generator().manual_seed(0))
    p = model.params()
    hw, hb = fused_decoder.permute_head(p["head"]["w"], p["head"]["b"], M)
    mask = torch.from_numpy(rng.random((500, 64)) < 0.75).to(dev)
    dec_args = (t(500, 64, W), t(500, 64, 2), mask, t(500, T, 64, M), t(500, T, 64, 2),
                p["dec"], hw, hb)
    dec_kw = dict(num_heads=H, num_mixtures=M, radius=4.0, sigma_min=1e-3, rho_max=0.99,
                  stats_mean=torch.zeros(2, device=dev), stats_std=torch.ones(2, device=dev))
    xy = torch.from_numpy(np.cumsum(rng.normal(size=(25, 64, 8, 2)), axis=2)
                          .astype(np.float32)).to(dev)
    stats = NormStats(torch.zeros(2, device=dev), torch.full((2,), 0.4, device=dev))
    gumbel, normal = model._rollout_stream(500, 64, torch.Generator(device=dev).manual_seed(1))
    x, g = t(5, 8192, 64), t(5, 8192, 192)
    x1, g1 = x[:1].contiguous(), g[:1].contiguous()
    grad_args = (t(1024, 64, W), t(1024, 64, H), t(1024, 64, H),
                 torch.from_numpy((rng.random((1024, 64, 64)) < 0.08).astype(np.float32)).to(dev),
                 t(1024, 64, W), H)
    out = {"root": str(root)}
    for name, fn, calls in (
            ("attend", lambda: fused_attend.attend(v, s_src, s_dst, att, H), CALLS),
            ("fused_gat", lambda: fused_gat.fused_gat(*gat_args), CALLS),
            ("fused_decode", lambda: fused_decoder.fused_decode(*dec_args, **dec_kw), 20),
            ("weight_grad_lanes_s5", lambda: dense_grad.weight_grad_lanes(x, g), CALLS),
            ("weight_grad_lanes_s1", lambda: dense_grad.weight_grad_lanes(x1, g1), CALLS),
            ("mm_s1", lambda: torch.mm(x1[0].T, g1[0]), CALLS),
            ("fused_gat_grad", lambda: fused_gat.fused_gat_grad(*grad_args), CALLS)):
        closed, issued = per_call(torch, fn, calls)
        out[f"{name}_us"], out[f"{name}_issue_us"] = 1e6 * closed, 1e6 * issued
    out["rollout_k_route_a_ms"] = 1e3 * per_call(
        torch, lambda: model.rollout_k(xy, mask[:25], stats, 20, stream=(gumbel, normal)),
        calls=20)[0]
    print(card_line())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
