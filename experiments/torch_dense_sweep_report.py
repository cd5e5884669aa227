#!/usr/bin/env python
"""Dense-rung design sweep report of the PyTorch port
(``experiments/dense_sweep_report.py`` over ``mmtraj_torch``).

Scores the univ-fold trees ``experiments/torch_dense_sweep.py`` trains, every
EMA checkpoint best-of-20 with sampling seed 0, per agent (ADE/FDE, MR@2m,
collision rate), i.i.d. and oversample-6, mean±std over the training seeds
(population std).  A single-seed run's flat tree (cell E) is read where its
``s{seed}`` directory is absent; an absent tree prints "(missing: tree)".

    python experiments/torch_dense_sweep_report.py [--runs runs]
        [--data-dir data/synthetic] [--route A|plain|both] [--seeds 0 1 2]
        [--device cpu]

The last line of standard output is the tables as JSON: {route: {"iid"|"os6":
{row: {"route": run, metric: [mean, std]}}}}, a missing row null.
"""

from __future__ import annotations

import json
import os
import sys

from torch_common import Scorer, ema_path, report_parser, routes_of, show, stats_row

CELLS = [  # tag, tree under {runs}/r5, seeds (None: the --seeds)
    ("control h64 4h r4", "dense_control", None),
    ("hidden=128 4h (hd32)", "dense_h128_heads4", None),
    ("gat_layers=2", "dense_gat2", None),
    ("radius=2", "dense_rad2", None),
    ("radius=8", "dense_rad8", None),
    ("n_max=128", "dense_n128", (0,)),
]
PROTOCOLS = ((1, "iid", "i.i.d. K=20"), (6, "os6", "oversample-6"))


def report(runs, data_dir, device, routes, seeds=(0, 1, 2)):
    """-> {route: {"iid"|"os6": {row: row or None}}}."""
    scorer = Scorer(data_dir, device)
    out = {}
    for route in routes:
        out[route] = {}
        for oversample, key, label in PROTOCOLS:
            t = out[route][key] = {}
            print(f"\n=== univ fold, {label} (EMA, exact-invariant eval, mean±std over seeds; "
                  f"route {route}) ===")
            for tag, name, cell_seeds in CELLS:
                tree = f"{runs}/r5/{name}"
                row = None
                if os.path.isdir(tree):
                    ms, ran = zip(*(scorer.score([ema_path(tree, s, flat_fallback=True)], "univ",
                                                 route, oversample)
                                    for s in (cell_seeds or seeds)))
                    row = stats_row(ms, "+".join(sorted(set(ran))))
                t[tag] = row
                show(tag, row, tree, width=22)
    return out


def main(argv=None) -> int:
    ap = report_parser(__doc__)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2],
                    help="the seeds of every cell but n_max=128 (seed 0)")
    args = ap.parse_args(argv)
    print(json.dumps(report(args.runs, args.data_dir, args.device, routes_of(args.route),
                            args.seeds)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
