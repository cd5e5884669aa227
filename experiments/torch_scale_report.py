#!/usr/bin/env python
"""Scale-out quality report of the PyTorch port
(``experiments/scale_report.py`` over ``mmtraj_torch``).

Scores the trees ``experiments/torch_scale_quality.py`` trains and the
600-frame control (dense-sweep's control, seed 0), each EMA checkpoint
best-of-20 with sampling seed 0, per agent, i.i.d. and oversample-6, on the
600-frame tree's held-out univ windows (the held-out scene is never
trained on, so one test set scores every row), with each run's training
wall clock: the last ``t`` in its ``metrics.jsonl``.

    python experiments/torch_scale_report.py [--runs runs] [--data-dir data/synthetic]
        [--route A|plain|both] [--device cpu]

The last line of standard output is the table as JSON: {route: {row:
{"route": run, "wall_s": s, "iid": [ade, fde], "os6": [ade, fde]}}}, a
missing row null.
"""

from __future__ import annotations

import json
import os
import sys

from torch_common import Scorer, report_parser, routes_of

CELLS = [  # tag, tree under {runs}/r5
    ("control B=16 600f 32k", "dense_control/s0"),
    ("B=16 3000f 32k", "scale_b16_f3000"),
    ("B=256 3000f 2k", "scale_b256_f3000_2k"),
    ("B=256 3000f 4k", "scale_b256_f3000_4k"),
    ("B=256 6000f 4k", "scale_b256_f6000_4k"),
]


def wall_of(tree):
    """The last logged ``t`` (seconds) in the run's metrics.jsonl; None
    without one."""
    path = os.path.join(tree, "metrics.jsonl")
    if not os.path.exists(path):
        return None
    last = None
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            last = rec.get("t", last)
    return last


def report(runs, data_dir, device, routes):
    """-> {route: {row: row or None}}."""
    scorer = Scorer(data_dir, device)
    out = {}
    for route in routes:
        t = out[route] = {}
        print(f"{'cell':22s} {'wall(s)':>8s} {'iid ADE/FDE':>17s} {'os-6 ADE/FDE':>17s}  "
              f"(route {route})")
        for tag, name in CELLS:
            tree = f"{runs}/r5/{name}"
            if not os.path.isdir(tree):
                t[tag] = None
                print(f"{tag:22s} (missing)")
                continue
            path = os.path.join(tree, "checkpoint_ema.npz")
            mi, ran = scorer.score([path], "univ", route)
            mo, _ = scorer.score([path], "univ", route, oversample=6)
            w = wall_of(tree)
            t[tag] = {"route": ran, "wall_s": w, "iid": [mi["min_ade"], mi["min_fde"]],
                      "os6": [mo["min_ade"], mo["min_fde"]]}
            print(f"{tag:22s} {w if w is not None else float('nan'):8.0f} "
                  f"{mi['min_ade']:.4f}/{mi['min_fde']:.4f}   "
                  f"{mo['min_ade']:.4f}/{mo['min_fde']:.4f}  [{ran}]", flush=True)
    return out


def main(argv=None) -> int:
    args = report_parser(__doc__).parse_args(argv)
    print(json.dumps(report(args.runs, args.data_dir, args.device, routes_of(args.route))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
