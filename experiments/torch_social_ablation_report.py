#!/usr/bin/env python
"""Social-graph ablation report of the PyTorch port
(``experiments/social_ablation_report.py`` over ``mmtraj_torch``).

Scores the trees ``experiments/torch_social_ablation.py`` trains against the
social "on" tree, every EMA checkpoint best-of-20 with sampling seed 0, per
agent (ADE/FDE, MR@2m, collision rate), mean±std over the training seeds
(population std):

* A: social on/off on each of the five folds, and their averages; on =
  ``--on-tree`` (the JAX script's ``runs/r3/loo32k_variety``);
* B: adjacency radius on the zara1 fold: 4.0 (the on tree's zara1 rows), 2,
  8, inf;
* C: num_heads 1 and 4, config 4 on the univ fold.

    python experiments/torch_social_ablation_report.py [--runs runs]
        [--on-tree runs/r3/loo32k_variety] [--data-dir data/synthetic]
        [--route A|plain|both] [--seeds 0 1 2] [--device cpu]

A tree that is absent prints "(missing: tree)".  The last line of standard
output is the tables as JSON: {route: {row: {"route": run, metric: [mean,
std]}}}, a missing row null.
"""

from __future__ import annotations

import json
import math
import os
import sys

from torch_common import (METRICS, SCENES, Scorer, ema_path, report_parser, routes_of, show,
                          stats_row)


def seed_stats(scorer, tree, scene, seeds, route, flat_scene=False):
    """Mean±std over ``seeds`` of the tree's fold (``s{seed}/{scene}``, or
    ``s{seed}`` where the tree holds one fold) -> a row; None where the tree
    is absent."""
    if not os.path.isdir(tree):
        return None
    rows, ran = [], set()
    for s in seeds:
        path = ema_path(tree, s, None if flat_scene else scene)
        m, r = scorer.score([path], scene, route)
        rows.append(m)
        ran.add(r)
    return stats_row(rows, "+".join(sorted(ran)))


def report(runs, on_tree, data_dir, device, routes, seeds=(0, 1, 2)):
    """The three tables for each route -> {route: {row: row or None}}."""
    scorer = Scorer(data_dir, device)
    out = {}
    for route in routes:
        t = out[route] = {}
        print(f"=== A. social on/off, per fold (WTA-32k, seeds {list(seeds)}, EMA, K=20; "
              f"route {route}) ===")
        acc = {"on": [], "off": []}
        for scene in SCENES:
            for tag, tree in (("on", on_tree), ("off", f"{runs}/r4/loo32k_nosocial")):
                row = t[f"{scene} social={tag == 'on'}"] = seed_stats(scorer, tree, scene, seeds,
                                                                     route)
                show(f"{scene} social={tag == 'on'}", row, tree)
                if row is not None:
                    acc[tag].append(row)
        for tag in ("on", "off"):
            rows = acc[tag]
            avg = None if not rows else {
                "route": "+".join(sorted({r["route"] for r in rows})),
                **{k: [math.fsum(r[k][0] for r in rows) / len(rows), 0.0] for k in METRICS}}
            t[f"AVG social={tag == 'on'}"] = avg
            show(f"AVG social={tag == 'on'}", avg, "no fold")

        print(f"\n=== B. adjacency radius, zara1 fold (4.0 = the on tree; route {route}) ===")
        t["radius=4.0 (default)"] = seed_stats(scorer, on_tree, "zara1", seeds, route)
        show("radius=4.0 (default)", t["radius=4.0 (default)"], on_tree)
        for r, name in (("2", "rad2_zara1"), ("8", "rad8_zara1"), ("inf", "rad0_zara1")):
            tree = f"{runs}/r4/{name}"
            row = t[f"radius={r}"] = seed_stats(scorer, tree, "zara1", seeds, route,
                                                flat_scene=True)
            show(f"radius={r}", row, tree)

        print(f"\n=== C. num_heads, config-4 dense rung (univ fold; route {route}) ===")
        for h in ("1", "4"):
            tree = f"{runs}/r4/c4_univ_h{h}"
            row = t[f"num_heads={h}"] = seed_stats(scorer, tree, "univ", seeds, route,
                                                   flat_scene=True)
            show(f"num_heads={h}", row, tree)
    return out


def main(argv=None) -> int:
    ap = report_parser(__doc__)
    ap.add_argument("--on-tree", default=None,
                    help="the social=True tree (default {runs}/r3/loo32k_variety)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args(argv)
    on_tree = args.on_tree or f"{args.runs}/r3/loo32k_variety"
    out = report(args.runs, on_tree, args.data_dir, args.device, routes_of(args.route),
                 args.seeds)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
