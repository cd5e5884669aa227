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
device time sets its call), inputs from numpy seed 0.  Each
number is the median over 5 trials of ``CALLS`` back-to-back calls closed by
one ``torch.cuda.synchronize()``, in microseconds a call (milliseconds for
``rollout_k``), under ``torch.no_grad()``.

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


def per_call(torch, fn, calls: int = CALLS) -> float:
    """Median over TRIALS of the host seconds a call, closed by a synchronize."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TRIALS):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / calls)
    return statistics.median(times)


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
    from mmtraj_torch.ops import _build, fused_attend, fused_decoder, fused_gat

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
    out = {
        "root": str(root),
        "attend_us": 1e6 * per_call(torch, lambda: fused_attend.attend(v, s_src, s_dst, att, H)),
        "fused_gat_us": 1e6 * per_call(torch, lambda: fused_gat.fused_gat(*gat_args)),
        "fused_decode_us": 1e6 * per_call(
            torch, lambda: fused_decoder.fused_decode(*dec_args, **dec_kw), calls=20),
        "rollout_k_route_a_ms": 1e3 * per_call(
            torch, lambda: model.rollout_k(xy, mask[:25], stats, 20, stream=(gumbel, normal)),
            calls=20),
    }
    print(card_line())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
