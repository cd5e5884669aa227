#!/usr/bin/env python
"""Social-graph ablation training of the PyTorch port
(``experiments/social_ablation.sh``'s commands through ``mmtraj_torch.cli``).

On the WTA-32k quality recipe, three axes:

* A: config 3 with ``--no-social``, the five-fold leave-one-out protocol,
  seeds 0 1 2 (the social "on" arm is the recorded radius-4 tree,
  ``{runs}/r3/loo32k_variety``, which this does not train);
* B: config 3 on the zara1 fold at ``--adjacency-radius`` 2, 8 and 0
  (fully connected), seeds 0 1 2;
* C: config 4 on the univ fold at ``--num-heads`` 1 and 4, seeds 0 1 2.

    python experiments/torch_social_ablation.py [--arm A B2 B8 B0 C1 C4 | B | C]
        [--runs runs] [--data-dir data/synthetic] [--fast] [--steps N]
        [--seeds S ...] [--device cpu] [--dry-run]

``--arm`` picks commands by name prefix (``C`` is C1 and C4); the default is
all six.  Scored by ``experiments/torch_social_ablation_report.py``.
"""

from __future__ import annotations

import sys

from torch_common import RECIPE, train_parser, run_commands, select


def commands(runs: str, data_dir: str):
    """-> (names, [(title, argv)]) in the JAX script's order."""
    recipe = RECIPE + ["--steps", "32000", "--steps-per-dispatch", "50", "--data-dir", data_dir]
    a = "A. social=False, full 5-fold LOO, seeds 0 1 2"
    b = "B. adjacency radius sweep, zara1 fold, seeds 0 1 2"
    c = "C. num_heads 1 vs 4, config-4 dense rung (univ), seeds 0 1 2"
    names = ["A"]
    cmds = [(a, ["train", "--config", "3", "--scene", "all", "--seeds", "0", "1", "2",
                 "--no-social", *recipe, "--out-dir", f"{runs}/r4/loo32k_nosocial"])]
    for r in ("2", "8", "0"):
        names.append(f"B{r}")
        cmds.append((b, ["train", "--config", "3", "--scene", "zara1", "--seeds", "0", "1", "2",
                         "--adjacency-radius", r, *recipe, "--out-dir",
                         f"{runs}/r4/rad{r}_zara1"]))
    for h in ("1", "4"):
        names.append(f"C{h}")
        cmds.append((c, ["train", "--config", "4", "--scene", "univ", "--seeds", "0", "1", "2",
                         "--num-heads", h, *recipe, "--out-dir", f"{runs}/r4/c4_univ_h{h}"]))
    return names, cmds


def main(argv=None) -> int:
    ap = train_parser(__doc__)
    ap.add_argument("--data-dir", default="data/synthetic")
    ap.add_argument("--arm", nargs="+", default=[], help="A, B2, B8, B0, C1, C4 (or B, C)")
    args = ap.parse_args(argv)
    names, cmds = commands(args.runs, args.data_dir)
    run_commands(select(cmds, names, args.arm), args)
    if not args.dry_run:
        print("=== ablation training complete ===", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
