#!/usr/bin/env python
"""The five-fold heterogeneous ensemble, rnn (3 seeds) + attn (3 seeds), on the
PyTorch port (``experiments/mixed_loo.py`` over ``mmtraj_torch``).

Trees: ``{runs}/r3/loo32k_variety/s{0,1,2}/<scene>`` (rnn) and
``{runs}/r3/loo32k_attn/{s0,s1,<flat>}/<scene>`` (attention encoder, the
flat tree its third seed), EMA weights.  For each fold: each family's 3-seed
ensemble (``evaluate`` of one configuration) and the 6-member mixed one
(``evaluate_mixed``), best-of-20, sampling seed 0, per agent; then the
averages over the folds.

    python experiments/torch_mixed_loo.py [--runs runs] [--data-dir data/synthetic]
        [--route A|plain|both] [--device cpu]

The last line of standard output is the rows as JSON: {route: {"scene tag":
{"route": run, "min_ade": x, "min_fde": x, "miss_rate_2m": x}, "avg tag":
{"min_ade": x, "min_fde": x}}}.
"""

from __future__ import annotations

import json
import math
import sys
import time

from torch_common import SCENES, Scorer, report_parser, routes_of

RNN = ["r3/loo32k_variety/s0", "r3/loo32k_variety/s1", "r3/loo32k_variety/s2"]
ATTN = ["r3/loo32k_attn/s0", "r3/loo32k_attn/s1", "r3/loo32k_attn"]
TAGS = ("rnn ens3", "attn ens3", "mixed ens6")


def report(runs, data_dir, device, routes):
    """-> {route: {row: row}}."""
    scorer = Scorer(data_dir, device)
    out = {}
    for route in routes:
        t = out[route] = {}
        for scene in SCENES:
            t0 = time.time()
            rnn = [f"{runs}/{p}/{scene}/checkpoint_ema.npz" for p in RNN]
            attn = [f"{runs}/{p}/{scene}/checkpoint_ema.npz" for p in ATTN]
            for tag, paths, mixed in (("rnn ens3", rnn, False), ("attn ens3", attn, False),
                                      ("mixed ens6", rnn + attn, True)):
                m, ran = scorer.score(paths, scene, route, mixed=mixed)
                t[f"{scene} {tag}"] = {"route": ran, **{k: m[k] for k in (
                    "min_ade", "min_fde", "miss_rate_2m")}}
                print(f"{scene:8s} {tag:12s} ADE={m['min_ade']:.4f} FDE={m['min_fde']:.4f} "
                      f"MR={m['miss_rate_2m']:.4f} [{ran}]", flush=True)
            print(f"  ({time.time() - t0:.0f}s)", flush=True)
        print(f"\naverages over the 5 folds (route {route}):")
        for tag in TAGS:
            rows = [t[f"{s} {tag}"] for s in SCENES]
            a = math.fsum(r["min_ade"] for r in rows) / len(rows)
            f = math.fsum(r["min_fde"] for r in rows) / len(rows)
            t[f"avg {tag}"] = {"min_ade": a, "min_fde": f}
            print(f"{tag:12s} ADE={a:.4f} FDE={f:.4f}")
        print("recorded rnn ens5 headline: 0.3539 / 0.5031")
    return out


def main(argv=None) -> int:
    args = report_parser(__doc__).parse_args(argv)
    print(json.dumps(report(args.runs, args.data_dir, args.device, routes_of(args.route))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
