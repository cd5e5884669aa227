"""Shared by the PyTorch port's experiment scripts (``experiments/torch_*.py``).

They are the port's counterparts of the JAX scripts beside them
(``social_ablation.sh``, ``dense_sweep.sh``, ``scale_quality.sh`` and their
reports, and the three ``mixed_*.py``).  They import ``mmtraj_torch`` only.

Training scripts issue the JAX scripts' ``cli train`` commands through
``mmtraj_torch.cli`` in this process, flag for flag; ``--dry-run`` prints
them instead.  Reports score EMA checkpoints as the JAX reports do (K = 20,
sampling seed 0, per agent) on the route asked for:

* ``A``: the GAT through ``fused_gat`` (``use_pallas``) and the rollout
  through ``fused_decode``, where the model allows it (GRU, social, one GAT
  round, a finite radius, a tileable N_max); ``use_pallas`` alone where the
  fused decoder does not cover the model (``--gat-layers 2``, radius 0);
  plain where the model has no GAT (``--no-social``).  Each row names the
  route it ran.
* ``plain``: no kernel.

Entry points run on the card unless the caller passes ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import shlex
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# The WTA-32k quality recipe of the JAX scripts (``social_ablation.sh:18-20``),
# without its --steps and data flags, which differ between the scripts.
RECIPE = ["--loss", "variety", "--variety-n", "8", "--augment", "--augment-flip", "--dropout",
          "0.1", "--weight-decay", "1e-4", "--ema-decay", "0.995", "--lr-schedule", "cosine"]
SCENES = ("eth", "hotel", "univ", "zara1", "zara2")
METRICS = ("min_ade", "min_fde", "miss_rate_2m", "collision_rate")
K = 20
FUSED_DECODER_N = (8, 16, 32, 64, 128)  # the agent counts fused_decode tiles


def require_device(device: str) -> None:
    """Stop with an error where the card is asked for and there is none."""
    if str(device).startswith("cpu"):
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit(f"no CUDA device for --device {device}; pass --device cpu to run on "
                         "the CPU")


# -- training scripts ------------------------------------------------------------------


def train_parser(doc: str) -> argparse.ArgumentParser:
    """The options every training script takes."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--runs", default="runs", help="root of the run trees (default runs)")
    ap.add_argument("--dry-run", action="store_true", help="print each command, run nothing")
    ap.add_argument("--steps", type=int, default=None,
                    help="replaces each command's --steps (a smoke run); at 100 or fewer it "
                         "also sets --warmup-steps N // 2, as the cosine schedule needs")
    ap.add_argument("--seeds", type=int, nargs="+", default=None,
                    help="replaces each command's --seeds")
    ap.add_argument("--fast", action="store_true",
                    help="the card's kernels: adds --use-pallas, and --vmap-seeds where a "
                         "command trains at least two seeds")
    ap.add_argument("--device", default=None,
                    help="passed to every cli train (its default: cuda)")
    return ap


def _replace(argv, flag, values):
    """``argv`` with the values after ``flag`` replaced by ``values``."""
    i = argv.index(flag)
    j = i + 1
    while j < len(argv) and not argv[j].startswith("--"):
        j += 1
    return argv[:i + 1] + [str(v) for v in values] + argv[j:]


def finish(argv, args):
    """A JAX script's command with the script's options applied: --steps and
    --seeds replaced, then the --fast flags and --device appended."""
    argv = list(argv)
    if argv[0] != "train":
        return argv
    if args.steps is not None:
        argv = _replace(argv, "--steps", [args.steps])
        if args.steps <= 100:
            argv += ["--warmup-steps", str(args.steps // 2)]
    if args.seeds is not None:
        argv = _replace(argv, "--seeds", args.seeds)
    if args.fast:
        i = argv.index("--seeds")
        n_seeds = next((j for j, a in enumerate(argv[i + 1:]) if a.startswith("--")),
                       len(argv) - i - 1)
        argv += ["--use-pallas"] + (["--vmap-seeds"] if n_seeds >= 2 else [])
    if args.device is not None:
        argv += ["--device", args.device]
    return argv


def run_commands(commands, args, log=print) -> None:
    """Run (or with --dry-run print) ``commands``: (title, argv) pairs of
    ``mmtraj_torch.cli``.  A title is printed before its commands, as the JAX
    script echoes it.  A command that exits nonzero raises."""
    if not args.dry_run:
        require_device(args.device or "cuda")
    title = None
    for head, argv in commands:
        argv = finish(argv, args)
        if args.dry_run:
            print("python -m mmtraj_torch.cli " + shlex.join(argv), flush=True)
            continue
        if head != title:
            log(f"=== {head} ===")
            title = head
        from mmtraj_torch.cli import main as cli_main

        rc = cli_main(argv)
        if rc != 0:
            raise RuntimeError(f"mmtraj_torch.cli {shlex.join(argv)} exited {rc}")


def select(commands, names, chosen):
    """The (title, argv) pairs whose name starts with one of ``chosen``
    (every pair where ``chosen`` is empty); ``names`` names each pair."""
    if not chosen:
        return list(commands)
    unknown = [c for c in chosen if not any(n.startswith(c) for n in names)]
    if unknown:
        raise SystemExit(f"unknown selection {unknown}; choose from {list(names)}")
    return [c for c, n in zip(commands, names) if any(n.startswith(x) for x in chosen)]


# -- reports ----------------------------------------------------------------------------


def report_parser(doc: str) -> argparse.ArgumentParser:
    """The options every report takes."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--runs", default="runs", help="root of the run trees (default runs)")
    ap.add_argument("--data-dir", default="data/synthetic",
                    help="the annotation files scored (default data/synthetic)")
    ap.add_argument("--route", default="A", choices=("A", "plain", "both"),
                    help="A: the card's kernels where the model allows them; plain: none")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return ap


def routes_of(route: str):
    return ("A", "plain") if route == "both" else (route,)


def route_config(mcfg, n_max: int, route: str):
    """The model configuration that scores on ``route`` -> (config, the route
    it runs: "A", "use_pallas" or "plain")."""
    plain = dataclasses.replace(mcfg, use_pallas=False, use_fused_decoder=False,
                                attend_kernel="xla")
    if route == "plain" or not mcfg.social:
        return plain, "plain"
    fused = (mcfg.cell == "gru" and mcfg.head == "gmm" and mcfg.gat_layers == 1
             and mcfg.adjacency_radius > 0 and n_max in FUSED_DECODER_N)
    return (dataclasses.replace(plain, use_pallas=True, use_fused_decoder=fused),
            "A" if fused else "use_pallas")


def mean_std(vals):
    """Mean and population std (over ``len(vals)``), as the JAX scripts take them."""
    mu = math.fsum(vals) / len(vals)
    return mu, (math.fsum((v - mu) ** 2 for v in vals) / len(vals)) ** 0.5


class Scorer:
    """Loads checkpoints and held-out scenes (each scene once) and scores
    them with the port's ``evaluate``/``evaluate_mixed``."""

    def __init__(self, data_dir: str, device: str):
        require_device(device)
        self.data_dir, self.device = data_dir, device
        self._ds = {}

    def dataset(self, scene: str, cfg):
        from mmtraj_torch.data.collate import WindowDataset
        from mmtraj_torch.data.registry import load_scene_windows

        d = cfg.data
        key = (scene, d.obs_len, d.pred_len, d.stride, d.min_agents, d.n_max)
        if key not in self._ds:
            windows = load_scene_windows(self.data_dir, scene, d.obs_len, d.pred_len, d.stride,
                                         d.min_agents)
            self._ds[key] = WindowDataset(windows, d.n_max)
        return self._ds[key]

    def score(self, paths, scene, route: str, oversample: int = 1, mixed: bool = False,
              data_cfg=None):
        """Best-of-20 metrics of the checkpoints at ``paths`` on ``scene`` (the
        first checkpoint's stats, and its data config unless ``data_cfg``
        is given): one checkpoint, an ensemble of one configuration
        (``evaluate``) or, with ``mixed``, of any (``evaluate_mixed``) ->
        (metrics, the routes run, joined)."""
        from mmtraj_torch import checkpoint
        from mmtraj_torch import evaluate as ev
        from mmtraj_torch.models.forecaster import Forecaster

        cks = [checkpoint.load(p) for p in paths]
        models, ran = [], set()
        for ck in cks:
            d = ck.config.data
            mcfg, r = route_config(ck.config.model, d.n_max, route)
            models.append(Forecaster(mcfg, d.obs_len, d.pred_len, device=self.device,
                                     state=ck.state))
            ran.add(r)
        ds = self.dataset(scene, data_cfg or cks[0].config)
        if mixed:
            m = ev.evaluate_mixed(models, cks[0].stats, ds, K, seed=0, oversample=oversample)
        else:
            m = ev.evaluate(models[0] if len(models) == 1 else models, cks[0].stats, ds, K,
                            seed=0, oversample=oversample)
        return m, "+".join(sorted(ran))


def stats_row(rows, route):
    """Seed rows (metric dicts) -> {"route": ..., metric: [mean, std]}."""
    return {"route": route, **{k: list(mean_std([float(r[k]) for r in rows])) for k in METRICS}}


def show(tag, row, tree=None, width=26) -> None:
    """The JAX reports' line for one row, and the route it ran; "(missing:
    tree)" for a row without its tree."""
    if row is None:
        print(f"{tag:{width}s} (missing: {tree})", flush=True)
        return
    print(f"{tag:{width}s} "
          f"ADE={row['min_ade'][0]:.4f}±{row['min_ade'][1]:.4f} "
          f"FDE={row['min_fde'][0]:.4f}±{row['min_fde'][1]:.4f} "
          f"MR@2m={row['miss_rate_2m'][0]:.4f}±{row['miss_rate_2m'][1]:.4f} "
          f"coll={row['collision_rate'][0]:.4f}±{row['collision_rate'][1]:.4f} "
          f"[{row['route']}]", flush=True)


def ema_path(tree, seed, scene=None, flat_fallback=False) -> str:
    """``{tree}/s{seed}[/{scene}]/checkpoint_ema.npz``; with ``flat_fallback``
    a single-seed run's ``{tree}/checkpoint_ema.npz`` where the seed's
    directory is absent."""
    path = os.path.join(tree, f"s{seed}", *([scene] if scene else []), "checkpoint_ema.npz")
    if flat_fallback and not os.path.exists(path):
        path = os.path.join(tree, "checkpoint_ema.npz")
    return path
