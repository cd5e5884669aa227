#!/usr/bin/env python
"""Heterogeneous (rnn + attn) ensembles on the zara1 fold, on the PyTorch port
(``experiments/mixed_zara1_probe.py`` over ``mmtraj_torch``).

Members: an rnn checkpoint (``{runs}/r3/rnn_zara1_s0``) and two attention-
encoder checkpoints (``{runs}/r3/probe_attn_l3``, ``probe_attn_l4``), each
its EMA weights.  Single-member rows (``evaluate``) check the harness; mixed
rows (``evaluate_mixed``) ask whether family diversity beats the same
candidate budget spent on one family.  Best-of-20, sampling seed 0, per
agent.

    python experiments/torch_mixed_zara1_probe.py [--runs runs]
        [--data-dir data/synthetic] [--route A|plain|both] [--device cpu]

The last line of standard output is the rows as JSON: {route: {"tag os=N":
{"route": run, "min_ade": x, "min_fde": x, "miss_rate_2m": x}}}.
"""

from __future__ import annotations

import json
import sys
import time

from torch_common import Scorer, report_parser, routes_of

CKPTS = {"rnn": "r3/rnn_zara1_s0", "attn3": "r3/probe_attn_l3", "attn4": "r3/probe_attn_l4"}
ROWS = [  # tag, members, oversample
    ("rnn (recorded .3474/.4979)", ["rnn"], 6),
    ("attn3 (recorded .3496/.5091)", ["attn3"], 6),
    ("mixed rnn+attn3", ["rnn", "attn3"], 3),  # os-6's 120 candidates, two families
    ("mixed rnn+attn3", ["rnn", "attn3"], 6),
    ("mixed rnn+attn3+attn4", ["rnn", "attn3", "attn4"], 2),
    ("mixed rnn+attn3+attn4", ["rnn", "attn3", "attn4"], 4),
    ("rnn alone", ["rnn"], 3),
    ("attn3 alone", ["attn3"], 3),
]


def report(runs, data_dir, device, routes):
    """-> {route: {"tag os=N": row}}."""
    from mmtraj_torch import checkpoint

    scorer = Scorer(data_dir, device)
    paths = {k: f"{runs}/{v}/checkpoint_ema.npz" for k, v in CKPTS.items()}
    cfg = checkpoint.load(paths["rnn"]).config
    ds = scorer.dataset(cfg.data.scene, cfg)
    print(f"{cfg.data.scene} fold: {len(ds)} test windows, n_max={ds.n_max}")
    out = {}
    for route in routes:
        t = out[route] = {}
        for tag, names, oversample in ROWS:
            t0 = time.time()
            m, ran = scorer.score([paths[n] for n in names], cfg.data.scene, route, oversample,
                                  mixed=len(names) > 1, data_cfg=cfg)
            t[f"{tag} os={oversample}"] = {"route": ran, **{k: m[k] for k in (
                "min_ade", "min_fde", "miss_rate_2m")}}
            print(f"{tag:28s} os={oversample}  ADE={m['min_ade']:.4f}  FDE={m['min_fde']:.4f}  "
                  f"MR@2m={m['miss_rate_2m']:.4f}  ({time.time() - t0:.0f}s) [{ran}]",
                  flush=True)
    return out


def main(argv=None) -> int:
    args = report_parser(__doc__).parse_args(argv)
    print(json.dumps(report(args.runs, args.data_dir, args.device, routes_of(args.route))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
