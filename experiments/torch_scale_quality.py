#!/usr/bin/env python
"""Scale-out quality training of the PyTorch port
(``experiments/scale_quality.sh``'s commands through ``mmtraj_torch.cli``).

Data volume and batch under the WTA quality recipe on the univ fold, seed 0:
``generate-data --n-frames 3000`` and ``6000`` where a tree's ``eth.txt`` is
absent, then

* data5x: config 4 (B = 16), 3,000 frames a scene, 32,000 steps;
* big-batch: config 5 (B = 256), 3,000 frames, 2,000 steps;
* big-batch+: config 5, 3,000 frames, 4,000 steps;
* data10x: config 5, 6,000 frames, 4,000 steps.

The 600-frame control row is dense-sweep's control, seed 0.

    python experiments/torch_scale_quality.py [--row data5x big-batch big-batch+ data10x]
        [--runs runs] [--data-root data] [--fast] [--steps N] [--device cpu] [--dry-run]

Scored by ``experiments/torch_scale_report.py``.
"""

from __future__ import annotations

import os
import sys

from torch_common import RECIPE, train_parser, run_commands

ROWS = [  # name, title, config, steps, frames, out dir under {runs}/r5
    ("data5x", "data5x: B=16, 3000 frames, 32k steps", "4", "32000", "3000", "scale_b16_f3000"),
    ("big-batch", "big-batch: B=256 (config-5 shape), 3000 frames, 2k steps", "5", "2000",
     "3000", "scale_b256_f3000_2k"),
    ("big-batch+", "big-batch+: B=256, 3000 frames, 4k steps", "5", "4000", "3000",
     "scale_b256_f3000_4k"),
    ("data10x", "data10x: B=256, 6000 frames, 4k steps", "5", "4000", "6000",
     "scale_b256_f6000_4k"),
]


def commands(runs: str, data_root: str):
    """-> (names, [(title, argv)]) in the JAX script's order, the data
    generation first where its files are absent."""
    recipe = RECIPE + ["--steps-per-dispatch", "50"]
    names, cmds = [], []
    for f in ("3000", "6000"):
        if not os.path.isfile(os.path.join(data_root, f"synthetic{f}", "eth.txt")):
            names.append(f"data{f}")
            cmds.append((f"generate-data {f}", ["generate-data", "--data-dir",
                                                f"{data_root}/synthetic{f}", "--seed", "0",
                                                "--n-frames", f]))
    for name, title, config, steps, frames, out in ROWS:
        names.append(name)
        cmds.append((title, ["train", "--config", config, "--scene", "univ", "--seeds", "0",
                             "--steps", steps, *recipe, "--data-dir",
                             f"{data_root}/synthetic{frames}", "--out-dir", f"{runs}/r5/{out}"]))
    return names, cmds


def main(argv=None) -> int:
    ap = train_parser(__doc__)
    ap.add_argument("--data-root", default="data",
                    help="holds synthetic3000/ and synthetic6000/ (default data)")
    ap.add_argument("--row", nargs="+", default=[], help="data5x, big-batch, big-batch+, data10x")
    args = ap.parse_args(argv)
    names, cmds = commands(args.runs, args.data_root)
    if args.row:
        unknown = set(args.row) - {r[0] for r in ROWS}
        if unknown:
            raise SystemExit(f"unknown row {sorted(unknown)}; choose from {[r[0] for r in ROWS]}")
        frames = {r[4] for r in ROWS if r[0] in args.row}
        cmds = [c for c, n in zip(cmds, names) if n in args.row or n[4:] in frames]
    run_commands(cmds, args)
    if not args.dry_run:
        print("=== scale-quality training complete ===", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
