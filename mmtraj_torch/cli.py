"""Command-line entry point of the port (counterpart of ``mmtraj/cli.py``).
Only ``eval`` is ported: it scores a checkpoint on the held-out scene and
prints the JAX package's eval line.

Usage:
  python -m mmtraj_torch.cli eval --ckpt runs/x/checkpoint.npz --data-dir data/synthetic3000
  python -m mmtraj_torch.cli eval --ckpt ... --data-dir ... --device cpu

It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

from mmtraj_torch.config import SCENES
from mmtraj_torch.params import not_ported


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="mmtraj_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    ep = sub.add_parser("eval", help="evaluate a checkpoint (best-of-K ADE/FDE)")
    ep.add_argument("--ckpt", required=True, help="an npz checkpoint (either package's)")
    ep.add_argument("--data-dir", default=None, help="annotation dir ({scene}.txt files)")
    ep.add_argument("--scene", default=None, choices=SCENES, help="held-out scene")
    ep.add_argument("--k", type=int, default=None, help="K samples for best-of-K")
    ep.add_argument("--obs-len", type=int, default=None)
    ep.add_argument("--pred-len", type=int, default=None)
    ep.add_argument("--n-max", type=int, default=None, help="padded agent capacity")
    ep.add_argument("--batch-size", type=int, default=None,
                    help="eval batch; default: evaluate.vmem_friendly_batch, the JAX "
                         "package's TPU-sized default (see autotune_eval_batch)")
    ep.add_argument("--seed", type=int, default=0)
    ep.add_argument("--sigma-scale", type=float, default=1.0,
                    help="GMM sampling temperature (1.0 = untempered protocol)")
    ep.add_argument("--oversample", type=int, default=1,
                    help="sample oversample*K rollouts and keep the K most "
                         "endpoint-diverse per agent")
    ep.add_argument("--tta", type=int, default=1,
                    help="pool candidates from this many orthogonal views, then select K")
    ep.add_argument("--rollout", default="sample", choices=("sample", "modes"),
                    help="'sample': K sampled rollouts; 'modes': one trajectory per "
                         "mixture component")
    ep.add_argument("--data-parallel", action="store_true", help="not ported")
    ep.add_argument("--reduction", default="per_agent", choices=("per_agent", "per_window"))
    ep.add_argument("--dtype", default=None, choices=("float32", "bfloat16"),
                    help="override the model compute dtype (bfloat16 is not ported)")
    ep.add_argument("--buckets", type=int, nargs="+", default=None,
                    help="agent-capacity shape buckets, e.g. 16 32 64")
    ep.add_argument("--auto-n-max", action="store_true",
                    help="raise n_max to the densest test window so no agent is dropped")
    ep.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return ap


def _load_eval_dataset(cfg, auto_n_max: bool):
    """The held-out scene as a WindowDataset, n_max raised to the densest
    window under ``auto_n_max``, with the overflow warning."""
    from mmtraj_torch.data.collate import WindowDataset
    from mmtraj_torch.data.registry import load_scene_windows

    windows = load_scene_windows(cfg.data.data_dir, cfg.data.scene, cfg.data.obs_len,
                                 cfg.data.pred_len, cfg.data.stride, cfg.data.min_agents)
    n_max = cfg.data.n_max
    densest = max((w.shape[0] for w in windows), default=0)
    if auto_n_max and densest > n_max:
        print(f"auto-n-max: raising n_max {n_max} -> {densest} "
              "(densest window) so no agent is dropped")
        n_max = densest
    ds = WindowDataset(windows, n_max)
    if ds.n_dropped:
        print(f"WARNING: {ds.n_dropped} agents exceed n_max={n_max} and are "
              "excluded from the metric population (use --auto-n-max)")
    return ds


def _apply_overrides(cfg, args):
    dk = {k: v for k, v in {
        "data_dir": args.data_dir, "scene": args.scene, "obs_len": args.obs_len,
        "pred_len": args.pred_len, "n_max": args.n_max,
    }.items() if v is not None}
    tk = {"k_samples": args.k} if args.k is not None else {}
    mk = {"dtype": args.dtype} if args.dtype is not None else {}
    return cfg.replace(
        model=dataclasses.replace(cfg.model, **mk),
        data=dataclasses.replace(cfg.data, **dk),
        train=dataclasses.replace(cfg.train, **tk),
    )


def _load_checkpoint(path: str):
    if path.endswith((".pt", ".pth", ".h5", ".hdf5")) or os.path.isdir(path):
        raise not_ported(f"checkpoint {path!r}: the .pt, .h5 and Orbax formats",
                         "item 4, checkpoint.py and interop.py")
    from mmtraj_torch.params import load_npz

    return load_npz(path)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.data_parallel:
        raise not_ported("eval --data-parallel", "item 6, scale-out")
    if args.dtype == "bfloat16":
        raise not_ported("eval --dtype bfloat16", "item 3, LSTM, imported GRU biases and bf16")
    from mmtraj_torch.evaluate import evaluate
    from mmtraj_torch.models.forecaster import Forecaster

    ck = _load_checkpoint(args.ckpt)
    cfg = _apply_overrides(ck.config, args)
    ds = _load_eval_dataset(cfg, args.auto_n_max)
    model = Forecaster(cfg.model, cfg.data.obs_len, cfg.data.pred_len, device=args.device,
                       state=ck.state)
    m = evaluate(model, ck.stats, ds, cfg.train.k_samples, args.batch_size, args.seed,
                 reduction=args.reduction, sigma_scale=args.sigma_scale,
                 rollout=args.rollout, oversample=args.oversample, tta=args.tta,
                 buckets=args.buckets)
    red = m["reduction"] + (", modes" if args.rollout == "modes" else "")
    print(
        f"scene={cfg.data.scene} step={ck.step} windows={m['n_windows']} "
        f"agents={m['n_agents']} dropped={m['n_dropped']}: "
        f"best-of-{m['k']} ({red}) "
        f"ADE={m['min_ade']:.4f}m FDE={m['min_fde']:.4f}m "
        f"MR@2m={m['miss_rate_2m']:.3f} coll@0.2m={m['collision_rate']:.3f}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
