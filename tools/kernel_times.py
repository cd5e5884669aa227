#!/usr/bin/env python
"""Device times of the port's CUDA kernels at the shapes of their paths, for
one checkout of this repo, so that two checkouts can be held side by side on
one card (run it once for each, in turns, in one call), and fused_decode's
errors on the inputs its GPU tests check.

``--root`` names the checkout whose ``mmtraj_torch`` is imported and built
(default: this one).  Inputs come from ``tools/kernel_inputs.py``, as the
GPU tests make them, from seed 0 at config-4 widths (hidden = embed = HD =
64, 4 heads, M = 5, T = 12): attend at the flagship's (500, 64) and the dense
crowd's shapes, with 8% of the attend tile set; attend_packed at (500, 64);
fused_gat at (25, 64), the flagship's encoder, then at the dense crowd's
encoder (12, 128) and the decoder step's (500, 64); fused_decode at
(500, 12, 64) and (240, 12, 128) with glorot-normal weights.  Each time is
the median over 11 replays of a CUDA graph of 5 back-to-back calls (2 for
fused_decode), as ``chip_smoke.py`` times them, so the host's cost of a call
is left out.

``decode_errors``: for each of ``kernel_inputs.DECODER_CASES`` (100 rollout
graphs), the largest error over valid agents of fused_decode against
``reference_decode`` and the number of graphs past 1e-3 m; and the same for
``reference_decode`` against itself with every h0 moved by one ulp, which
is how far float32's rounding alone moves these rollouts.

Prints the card's name and power limit, then one JSON line.  Needs a CUDA
device; exits 1 without one.  Usage:
    python tools/kernel_times.py [--root DIR]
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))
from chip_smoke import time_ms  # noqa: E402  (this checkout's timing, whatever --root is)
from kernel_inputs import (DECODER_CASES, attend_tile, decoder_case, decoder_params,  # noqa: E402
                           decoder_stream, rollout_errors, tensor)

ATTEND_SHAPES = [(500, 64), (240, 128), (12, 128), (96, 128), (240, 256), (12, 256)]
DECODE_SHAPES = [(500, 64), (240, 128)]
GAT_SHAPES = [(12, 128), (500, 64)]  # after (25, 64), drawn after fused_decode's inputs
W, H, M, T = 64, 4, 5, 12


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    ops = {m: importlib.import_module(f"mmtraj_torch.ops.{m}")
           for m in ("_build", "fused_attend", "fused_gat", "fused_decoder")}
    torch.backends.cuda.matmul.allow_tf32 = False
    ops["_build"].build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(0)

    def t(*shape, scale=1.0):
        return tensor(rng, *shape, scale=scale)

    rows = []
    fa = ops["fused_attend"]
    for b, n in ATTEND_SHAPES:
        a = (t(b, n, W), t(b, n, H, scale=2), t(b, n, H, scale=2), attend_tile(rng, b, n, density=0.08))
        rows.append({"name": "attend", "shape": [b, n, W],
                     "ms": time_ms(torch, lambda: fa.attend(*a, H))})
        if (b, n) == (500, 64):
            rows.append({"name": "attend_packed", "shape": [b, n, W],
                         "ms": time_ms(torch, lambda: fa.attend(*a, H, 8, True))})
    g = (t(25, 64, W), attend_tile(rng, 25, 64, density=0.08), t(W, W, scale=W ** -0.5),
         t(H, W // H, scale=0.25), t(H, W // H, scale=0.25), t(W, W, scale=W ** -0.5),
         t(W, scale=0.1))
    fg = ops["fused_gat"]
    rows.append({"name": "fused_gat", "shape": [25, 64, W],
                 "ms": time_ms(torch, lambda: fg.fused_gat(*g, H))})
    fd = ops["fused_decoder"]
    p, hw, hb = decoder_params(rng, W, W, W, H, M)
    hw, hb = fd.permute_head(hw, hb, M)
    kw = dict(num_heads=H, num_mixtures=M, radius=4.0, sigma_min=1e-3, rho_max=0.99,
              stats_mean=torch.zeros(2, device="cuda"), stats_std=torch.full((2,), 0.4, device="cuda"))
    for bk, n in DECODE_SHAPES:
        mask = torch.from_numpy(rng.random((bk, n)) < 0.75).cuda()
        d = (t(bk, n, W), t(bk, n, 2, scale=3), mask, *decoder_stream(rng, bk, T, n, M), p, hw, hb)
        rows.append({"name": "fused_decode", "shape": [bk, T, n],
                     "ms": time_ms(torch, lambda: fd.fused_decode(*d, **kw), inner=2)})
    for b, n in GAT_SHAPES:
        a = (t(b, n, W), attend_tile(rng, b, n, density=0.08), *g[2:])
        rows.append({"name": "fused_gat", "shape": [b, n, W],
                     "ms": time_ms(torch, lambda: fg.fused_gat(*a, H))})
    errors = []
    for case in DECODER_CASES:
        d, ckw = decoder_case(fd, *case)
        want = fd.reference_decode(*d, **ckw)
        nudged = (torch.nextafter(d[0], torch.full_like(d[0], np.inf)), *d[1:])
        kernel = rollout_errors(fd.fused_decode(*d, **ckw), want, d[2])
        ulp = rollout_errors(fd.reference_decode(*nudged, **ckw), want, d[2])
        errors.append({"case": list(case), "graphs": d[0].shape[0], "kernel_max": kernel[0],
                       "kernel_past": kernel[1], "h0_ulp_max": ulp[0], "h0_ulp_past": ulp[1]})
    print(card)
    print(json.dumps({"root": str(Path(args.root).resolve()), "device": torch.cuda.get_device_name(0),
                      "kernels": rows, "decode_errors": errors}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
