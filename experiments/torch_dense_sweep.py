#!/usr/bin/env python
"""Dense-rung design sweep training of the PyTorch port
(``experiments/dense_sweep.sh``'s commands through ``mmtraj_torch.cli``).

Config 4 on the univ fold with the WTA-32k quality recipe, seeds 0 1 2:

* control: hidden 64, 4 heads, radius 4;
* A: ``--hidden-dim 128`` (4 heads of 32: ``fused_gat`` at D = HD = 128,
  ``fused_decode`` at hidden 128);
* B: ``--gat-layers 2``;
* C, D: ``--adjacency-radius`` 2 and 8;
* E: ``--n-max 128``, seed 0 only.

    python experiments/torch_dense_sweep.py [--cell control A B C D E]
        [--runs runs] [--data-dir data/synthetic] [--fast] [--steps N]
        [--seeds S ...] [--device cpu] [--dry-run]

Scored by ``experiments/torch_dense_sweep_report.py``.
"""

from __future__ import annotations

import sys

from torch_common import RECIPE, train_parser, run_commands, select


def commands(runs: str, data_dir: str):
    """-> (names, [(title, argv)]) in the JAX script's order."""
    recipe = RECIPE + ["--steps", "32000", "--steps-per-dispatch", "50", "--data-dir", data_dir]
    base = ["train", "--config", "4", "--scene", "univ", "--seeds"]
    s3 = base + ["0", "1", "2"]
    cd = "C/D: adjacency radius 2 / 8 on the dense fold"
    rows = [
        ("control", "control: c4 univ h=64 heads=4 r=4 (re-trained under today's code)",
         s3 + recipe + ["--out-dir", f"{runs}/r5/dense_control"]),
        ("A", "A: hidden=128, heads=4 (head-dim 32 — the dense head-capacity cell)",
         s3 + ["--hidden-dim", "128"] + recipe + ["--out-dir", f"{runs}/r5/dense_h128_heads4"]),
        ("B", "B: gat_layers=2 (2-hop social receptive field per frame)",
         s3 + ["--gat-layers", "2"] + recipe + ["--out-dir", f"{runs}/r5/dense_gat2"]),
        ("C", cd, s3 + ["--adjacency-radius", "2"] + recipe + ["--out-dir",
                                                               f"{runs}/r5/dense_rad2"]),
        ("D", cd, s3 + ["--adjacency-radius", "8"] + recipe + ["--out-dir",
                                                               f"{runs}/r5/dense_rad8"]),
        ("E", "E: N_max=128 trained (Pallas-attend eval regime), seed 0",
         base + ["0", "--n-max", "128"] + recipe + ["--out-dir", f"{runs}/r5/dense_n128"]),
    ]
    return [n for n, _, _ in rows], [(t, a) for _, t, a in rows]


def main(argv=None) -> int:
    ap = train_parser(__doc__)
    ap.add_argument("--data-dir", default="data/synthetic")
    ap.add_argument("--cell", nargs="+", default=[], help="control, A, B, C, D, E")
    args = ap.parse_args(argv)
    names, cmds = commands(args.runs, args.data_dir)
    run_commands(select(cmds, names, args.cell), args)
    if not args.dry_run:
        print("=== dense sweep training complete ===", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
