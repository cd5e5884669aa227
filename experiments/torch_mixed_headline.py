#!/usr/bin/env python
"""Does adding attention-encoder members improve the rnn ens5 headline?  On the
PyTorch port (``experiments/mixed_headline.py`` over ``mmtraj_torch``).

For each fold: the rnn 5-seed ensemble (``{runs}/r3/loo32k_variety/s0..s4``,
``evaluate``) against the JAX package's recorded rows (``RECORDED_ENS5``),
then ens5 + 1 attn member (6 members, 120 candidates) and ens5 + 3 attn
members (8 members, 160 candidates) through ``evaluate_mixed``; the attn
trees as ``experiments/torch_mixed_loo.py`` reads them.  Best-of-20,
sampling seed 0, per agent; then the averages over the folds.

    python experiments/torch_mixed_headline.py [--runs runs]
        [--data-dir data/synthetic] [--route A|plain|both] [--device cpu]

The last line of standard output is the rows as JSON, as
``torch_mixed_loo.py``'s, the rnn ens5 rows with "recorded": [ade, fde].
"""

from __future__ import annotations

import json
import math
import sys
import time

from torch_common import SCENES, Scorer, report_parser, routes_of
from torch_mixed_loo import ATTN

RNN = [f"r3/loo32k_variety/s{s}" for s in range(5)]
# The JAX package's rnn ens5 rows (RESULTS.md's headline; mixed_headline.py:24-26).
RECORDED_ENS5 = {"eth": (0.3069, 0.4448), "hotel": (0.2865, 0.4325),
                 "univ": (0.4691, 0.6356), "zara1": (0.3442, 0.4899),
                 "zara2": (0.3626, 0.5126)}
TAGS = ("rnn ens5", "ens5+attn1", "ens5+attn3")


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
            for tag, paths, mixed in (("rnn ens5", rnn, False), ("ens5+attn1", rnn + attn[:1], True),
                                      ("ens5+attn3", rnn + attn, True)):
                m, ran = scorer.score(paths, scene, route, mixed=mixed)
                row = t[f"{scene} {tag}"] = {"route": ran, **{k: m[k] for k in (
                    "min_ade", "min_fde", "miss_rate_2m")}}
                line = (f"{scene:8s} {tag:12s} ADE={m['min_ade']:.4f} FDE={m['min_fde']:.4f} "
                        f"MR={m['miss_rate_2m']:.4f}")
                if tag == "rnn ens5":
                    ra, rf = row["recorded"] = RECORDED_ENS5[scene]
                    line += (f" (recorded {ra:.4f}/{rf:.4f} "
                             f"d={m['min_ade'] - ra:+.4f}/{m['min_fde'] - rf:+.4f})")
                print(f"{line} [{ran}]", flush=True)
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
