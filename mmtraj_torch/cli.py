"""Command-line entry point of the port (counterpart of ``mmtraj/cli.py``).

Subcommands: ``train`` (one scene, or with ``--scene all`` the five-fold
leave-one-out protocol, each scene held out in turn; ``--seeds`` runs one a
seed, ``--vmap-seeds`` trains them as one vmapped population;
``--data-parallel``, ``--stream``, ``--steps-per-dispatch``,
``--synthetic``, ``--profile``, ``--debug-nans`` and ``--tensorboard``),
``eval`` (scores a checkpoint on the held-out scene and prints the JAX
package's eval line), ``eval-loo`` (scores a ``train --scene all`` tree in
one process: a table of mean±std over seeds, or with ``--ensemble`` each
fold's seeds, and trees, pooled into one deep ensemble), ``baseline``
(closed-form constant- or zero-velocity ADE/FDE, no model),
``generate-data`` (the synthetic five-scene dataset), ``autotune-eval``
(the fastest eval batch on this card), ``convert`` (a checkpoint between
the .npz, .pt and .h5 formats and an Orbax directory, and to and from
Keras's legacy ``save_weights`` layout), ``profile-stats`` (the device time of a trace
that ``train --profile`` wrote), ``export`` (a frozen K-sample predictor
as a ``torch.export`` .pt2 artifact), ``serve`` (JSON-lines requests on
stdin answered from artifacts, protocol in ``mmtraj_torch/serve.py``) and
``predict`` (K sampled futures for every window of the held-out scene into
an .npz), ``visualize`` (K sampled futures of a few windows plotted to a
PNG; matplotlib), ``import-obsmat`` and ``import-vsp`` (raw BIWI obsmat and
UCY .vsp annotations to the canonical ``frame ped x y`` text) and ``cache``
(the size of the kernel build directory, ``--trim-gb``, ``--clear``).  The
commands that read a checkpoint read any format ``mmtraj_torch.checkpoint.load``
reads, the JAX package's Orbax directories among them.

Usage:
  python -m mmtraj_torch.cli generate-data --data-dir data/synthetic
  python -m mmtraj_torch.cli baseline --data-dir data/synthetic --scene all --baseline cv
  python -m mmtraj_torch.cli train --config 4 --data-dir data/synthetic3000 --out-dir runs/x
  python -m mmtraj_torch.cli train --config 4 --data-dir ... --scene all --seeds 0 1 2 --vmap-seeds
  python -m mmtraj_torch.cli eval-loo --loo-dir runs/loo [--ensemble]
  python -m mmtraj_torch.cli train --config 1 --data-dir ... --steps-per-dispatch 10
  python -m mmtraj_torch.cli train --config 4 --data-dir ... --profile --out-dir runs/p
  python -m mmtraj_torch.cli profile-stats --trace-dir runs/p/profile
  python -m mmtraj_torch.cli train --config 5 --data-dir ... --data-parallel
  python -m mmtraj_torch.cli train --config 4 --data-dir ... --stream
  python -m mmtraj_torch.cli eval --ckpt runs/x/checkpoint.npz --data-dir data/synthetic3000
  python -m mmtraj_torch.cli eval --ckpt runs/x/model.pt --dtype bfloat16
  python -m mmtraj_torch.cli autotune-eval --ckpt runs/x/checkpoint.npz
  python -m mmtraj_torch.cli eval --ckpt ... --data-dir ... --device cpu
  python -m mmtraj_torch.cli convert --src runs/x/checkpoint.npz --dst runs/x/model.pt
  python -m mmtraj_torch.cli convert --src runs/jax/orbax_ckpt --dst runs/x/checkpoint.npz
  python -m mmtraj_torch.cli eval --ckpt runs/jax/orbax_ckpt --data-dir data/synthetic3000
  python -m mmtraj_torch.cli convert --keras --src keras.h5 --like x.npz --dst imported.npz
  python -m mmtraj_torch.cli export --ckpt runs/x/checkpoint.npz --out runs/x/predictor.pt2
  python -m mmtraj_torch.cli serve --artifact runs/x/predictor.pt2 --aggregate 8 < requests.jsonl
  python -m mmtraj_torch.cli predict --ckpt runs/x/checkpoint.npz --out predictions.npz
  python -m mmtraj_torch.cli visualize --ckpt runs/x/checkpoint.npz --out predictions.png
  python -m mmtraj_torch.cli import-obsmat --src obsmat.txt --dst data/real/eth.txt
  python -m mmtraj_torch.cli import-vsp --src zara01.vsp --dst data/real/zara1.txt --scale 0.02
  python -m mmtraj_torch.cli cache [--trim-gb 1 | --clear]

It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from mmtraj_torch.config import SCENES, get_config


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data-dir", default=None, help="annotation dir ({scene}.txt files)")
    p.add_argument("--scene", default=None, choices=SCENES + ("all",),
                   help="held-out scene; 'all' (train and baseline only) runs the five-fold "
                        "leave-one-out protocol and reports the average")
    p.add_argument("--k", type=int, default=None, help="K samples for best-of-K eval")
    p.add_argument("--obs-len", type=int, default=None)
    p.add_argument("--pred-len", type=int, default=None)
    p.add_argument("--n-max", type=int, default=None, help="padded agent capacity")


def _add_train(sub) -> None:
    tp = sub.add_parser("train", help="train a forecaster on one device")
    tp.add_argument("--config", default="3", help="preset 1..5")
    _add_common(tp)
    tp.add_argument("--steps", type=int, default=None)
    tp.add_argument("--batch-size", type=int, default=None)
    tp.add_argument("--lr", type=float, default=None)
    tp.add_argument("--lr-schedule", default=None, choices=("constant", "cosine"))
    tp.add_argument("--warmup-steps", type=int, default=None,
                    help="linear LR warmup steps for --lr-schedule cosine")
    tp.add_argument("--ema-decay", type=float, default=None,
                    help=">0 enables EMA weights for eval + checkpoint_ema.npz")
    tp.add_argument("--dropout", type=float, default=None,
                    help="variational dropout rate on embed/GAT activations")
    tp.add_argument("--num-mixtures", type=int, default=None)
    tp.add_argument("--encoder", default=None, choices=("rnn", "attn"),
                    help="observation encoder family")
    tp.add_argument("--attn-layers", type=int, default=None)
    tp.add_argument("--social", dest="social", action="store_true", default=None,
                    help="enable the per-frame social GAT (presets 2-5 default on)")
    tp.add_argument("--no-social", dest="social", action="store_false",
                    help="ablate the social graph")
    tp.add_argument("--gat-layers", type=int, default=None)
    tp.add_argument("--num-heads", type=int, default=None)
    tp.add_argument("--adjacency-radius", type=float, default=None,
                    help="proximity-graph radius in meters; <=0 means fully connected")
    tp.add_argument("--hidden-dim", type=int, default=None)
    tp.add_argument("--remat-policy", default=None, choices=("full", "dots", "dots_no_batch"),
                    help="what the backward recomputes: 'full' all, 'dots' all but the "
                         "matrix products, 'dots_no_batch' all but the unbatched products")
    tp.add_argument("--attend-kernel", default=None, choices=("auto", "xla", "pallas"),
                    help="GAT attention-chain backend: 'pallas' pins the Hopper attend kernel")
    tp.add_argument("--use-pallas", action="store_true",
                    help="the whole GAT layer through the Hopper kernel (ModelConfig.use_pallas)")
    tp.add_argument("--weight-decay", type=float, default=None, help="AdamW decoupled weight decay")
    tp.add_argument("--loss", default=None, choices=("nll", "variety", "hybrid"))
    tp.add_argument("--variety-n", type=int, default=None)
    tp.add_argument("--variety-weight", type=float, default=None)
    tp.add_argument("--variety-fde-weight", type=float, default=None)
    tp.add_argument("--augment", action="store_true", help="random per-window rotation")
    tp.add_argument("--augment-flip", action="store_true",
                    help="also randomly reflect windows (implies --augment)")
    tp.add_argument("--seed", type=int, default=None)
    tp.add_argument("--seeds", type=int, nargs="+", default=None,
                    help="train one run a seed, each into {out-dir}/s{seed}, and report "
                         "mean±std (e.g. --seeds 0 1 2); with --scene all the multi-seed "
                         "leave-one-out table")
    tp.add_argument("--vmap-seeds", action="store_true",
                    help="train the --seeds sweep as one vmapped population "
                         "(mmtraj_torch/population.py): every kernel of a step runs once for "
                         "all seeds; same per-seed results and s{seed}/ checkpoints")
    tp.add_argument("--out-dir", default=None)
    tp.add_argument("--eval-every", type=int, default=None)
    tp.add_argument("--ckpt-every", type=int, default=None,
                    help="periodic checkpoint interval in steps (enables resume)")
    tp.add_argument("--resume", action="store_true",
                    help="resume from {out-dir}/checkpoint.npz if present")
    tp.add_argument("--data-parallel", action="store_true",
                    help="split each batch over the processes of a torch.distributed group "
                         "(one process a card; without a launcher a group of one)")
    tp.add_argument("--stream", action="store_true",
                    help="stream host batches through a pinned, double-buffered prefetch "
                         "instead of holding the window set on the device")
    tp.add_argument("--steps-per-dispatch", type=int, default=None,
                    help="M steps a host dispatch: on the card one step as a CUDA graph, "
                         "replayed M times (needs resident data, not --stream)")
    tp.add_argument("--synthetic", action="store_true",
                    help="generate synthetic data into --data-dir first")
    tp.add_argument("--profile", action="store_true",
                    help="write a torch.profiler trace to {out-dir}/profile")
    tp.add_argument("--debug-nans", action="store_true",
                    help="raise on the first NaN of any op, forward or backward (slow; "
                         "--steps-per-dispatch chunks then run eagerly)")
    tp.add_argument("--tensorboard", action="store_true",
                    help="mirror metrics as TensorBoard scalars to {out-dir}/tb")
    tp.add_argument("--device", default="cuda", help="torch device (default cuda)")


def build_parser() -> argparse.ArgumentParser:
    from mmtraj_torch import __version__

    ap = argparse.ArgumentParser(prog="mmtraj_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--version", action="version", version=f"mmtraj_torch {__version__}")
    sub = ap.add_subparsers(dest="cmd", required=True)
    _add_train(sub)
    ep = sub.add_parser("eval", help="evaluate a checkpoint (best-of-K ADE/FDE)")
    ep.add_argument("--ckpt", required=True,
                    help="a .npz, .pt or .h5 checkpoint or an Orbax directory (either "
                         "package's)")
    _add_common(ep)
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
    ep.add_argument("--data-parallel", action="store_true",
                    help="split each eval batch over the processes of a torch.distributed "
                         "group (without a launcher a group of one)")
    ep.add_argument("--reduction", default="per_agent", choices=("per_agent", "per_window"))
    ep.add_argument("--dtype", default=None, choices=("float32", "bfloat16"),
                    help="override the model compute dtype (bfloat16: the products' "
                         "operands rounded to bf16, their results float32)")
    ep.add_argument("--buckets", type=int, nargs="+", default=None,
                    help="agent-capacity shape buckets, e.g. 16 32 64")
    ep.add_argument("--auto-n-max", action="store_true",
                    help="raise n_max to the densest test window so no agent is dropped")
    ep.add_argument("--device", default="cuda", help="torch device (default cuda)")

    lp = sub.add_parser("eval-loo", help="evaluate a train --scene all checkpoint tree (one "
                                         "process, per-scene mean±std table over seeds)")
    lp.add_argument("--loo-dir", required=True, nargs="+",
                    help="the --out-dir given to train --scene all; contains {scene}/ (single "
                         "seed) or s{seed}/{scene}/ subdirs.  Several trees need --ensemble: "
                         "each fold pools every tree's checkpoints into one ensemble "
                         "(evaluate_mixed)")
    lp.add_argument("--seeds", type=int, nargs="+", default=None,
                    help="seeds to aggregate (default: detected from the layout)")
    lp.add_argument("--ema", action="store_true",
                    help="evaluate checkpoint_ema.npz instead of checkpoint.npz")
    lp.add_argument("--seed", type=int, default=0, help="eval sampling seed")
    lp.add_argument("--oversample", type=int, default=1)
    lp.add_argument("--tta", type=int, default=1,
                    help="orthogonal test-time-augmentation views per member (see eval --tta)")
    lp.add_argument("--ensemble", action="store_true",
                    help="pool each fold's per-seed checkpoints into one deep ensemble whose "
                         "candidates endpoint-diverse selection cuts to K (one row a scene)")
    lp.add_argument("--sigma-scale", type=float, default=1.0)
    lp.add_argument("--dtype", default=None, choices=("float32", "bfloat16"),
                    help="override the model compute dtype at eval time")
    lp.add_argument("--buckets", type=int, nargs="+", default=None,
                    help="agent-capacity shape buckets (see eval --buckets)")
    lp.add_argument("--reduction", default="per_agent", choices=("per_agent", "per_window"))
    lp.add_argument("--rollout", default="sample", choices=("sample", "modes"))
    lp.add_argument("--device", default="cuda", help="torch device (default cuda)")

    bp = sub.add_parser("baseline",
                        help="closed-form baseline ADE/FDE on the held-out scene (no model)")
    _add_common(bp)
    bp.add_argument("--baseline", default="cv", choices=("cv", "zv"),
                    help="cv: constant velocity (the standard anchor); zv: zero velocity "
                         "(freeze at the last position)")

    gp = sub.add_parser("generate-data", help="write the synthetic ETH/UCY-format dataset")
    gp.add_argument("--data-dir", required=True)
    gp.add_argument("--seed", type=int, default=0)
    gp.add_argument("--n-frames", type=int, default=600)

    at = sub.add_parser("autotune-eval",
                        help="measure the fastest eval batch size on this card; pass the "
                             "winner as eval --batch-size")
    at.add_argument("--ckpt", required=True)
    at.add_argument("--k", type=int, default=None)
    at.add_argument("--iters", type=int, default=20)
    at.add_argument("--batches", type=int, nargs="+", default=None,
                    help="candidate batch sizes to time (default: a bracket around "
                         "vmem_friendly_batch)")
    at.add_argument("--device", default="cuda", help="torch device (default cuda)")

    cp = sub.add_parser("convert",
                        help="convert a checkpoint between formats (orbax dir / .npz / .pt / .h5)")
    cp.add_argument("--src", required=True, help="source checkpoint path")
    cp.add_argument("--dst", required=True,
                    help="destination path; the suffix picks the format (none: an Orbax "
                         "directory)")
    cp.add_argument("--keras", action="store_true",
                    help="treat .h5 files as Keras's legacy save_weights layout (reference "
                         "layer names, mmtraj_torch/interop.py) instead of the flat h5; weights "
                         "only, so a Keras --src needs --like for the config and norm stats")
    cp.add_argument("--like", default=None,
                    help="with --keras and a Keras --src: the checkpoint whose config and norm "
                         "stats the Keras weights belong to")

    pp = sub.add_parser("profile-stats",
                        help="summarize a torch.profiler trace (device time by kernel)")
    pp.add_argument("--trace-dir", required=True,
                    help="dir containing *.pt.trace.json (e.g. {out-dir}/profile)")
    pp.add_argument("--top", type=int, default=15)

    xp = sub.add_parser("export", help="export a frozen K-sample predictor (torch.export .pt2)")
    xp.add_argument("--ckpt", required=True)
    xp.add_argument("--out", required=True, help="output .pt2 file")
    xp.add_argument("--batch", type=int, default=64)
    xp.add_argument("--k", type=int, default=None)
    xp.add_argument("--device", default="cuda",
                    help="the device the artifact runs on (default cuda)")
    xp.add_argument("--oversample", type=int, default=1,
                    help="bake sample-and-select into the artifact (draw R*K, return the K "
                         "most diverse per agent)")

    sv = sub.add_parser("serve", help="serve exported predictors: JSON-lines requests on stdin "
                                      "-> K-sample rollouts on stdout (mmtraj_torch/serve.py)")
    sv.add_argument("--artifact", required=True, nargs="+",
                    help="artifact(s) written by `export`; several = graduated capacities, "
                         "each request routed to the smallest artifact that holds it")
    sv.add_argument("--aggregate", type=int, default=1,
                    help="micro-batch up to N consecutive single-window same-seed requests "
                         "into one device call (semantics = client-side batching)")
    sv.add_argument("--window-ms", type=float, default=5.0,
                    help="max wait for the first request of a group to gather company "
                         "(only with --aggregate > 1)")
    sv.add_argument("--stats-every", type=int, default=0,
                    help="log one operational line (ok/err counts, qps, mean group size) to "
                         "stderr every N answered requests")
    sv.add_argument("--no-pipeline-encode", action="store_true",
                    help="serialize the fetch and encoding with device calls (debug escape "
                         "hatch; default overlaps them on a writer thread, same bytes/order)")

    rp = sub.add_parser("predict", help="sample K futures for a scene's windows -> .npz")
    rp.add_argument("--ckpt", required=True)
    _add_common(rp)
    rp.add_argument("--out", default="predictions.npz")
    rp.add_argument("--seed", type=int, default=0)
    rp.add_argument("--oversample", type=int, default=1,
                    help="sample R=oversample*K futures and keep the K most endpoint-diverse "
                         "per agent (see eval --oversample)")
    rp.add_argument("--batch-size", type=int, default=None,
                    help="default: eval's (evaluate.vmem_friendly_batch); the output does not "
                         "depend on it")
    rp.add_argument("--auto-n-max", action="store_true",
                    help="raise n_max to the densest window so no agent is dropped")
    rp.add_argument("--device", default="cuda", help="torch device (default cuda)")

    vp = sub.add_parser("visualize", help="render K-sample predictions to a PNG")
    vp.add_argument("--ckpt", required=True)
    _add_common(vp)
    vp.add_argument("--out", default="predictions.png")
    vp.add_argument("--windows", type=int, default=6)
    vp.add_argument("--seed", type=int, default=0)
    vp.add_argument("--device", default="cuda", help="torch device (default cuda)")

    op = sub.add_parser("import-obsmat",
                        help="convert a raw BIWI/ETH obsmat (.txt/.mat) to canonical annotation "
                             "txt (frame id x y)")
    op.add_argument("--src", required=True, help="obsmat.txt or obsmat.mat")
    op.add_argument("--dst", required=True, help="output path (e.g. data/real/eth.txt)")

    vs = sub.add_parser("import-vsp",
                        help="convert a raw UCY .vsp spline annotation (univ/zara) to canonical "
                             "annotation txt via a pixel->meter homography")
    vs.add_argument("--src", required=True, help="crowds .vsp file")
    vs.add_argument("--dst", required=True, help="output path (e.g. data/real/zara1.txt)")
    vs.add_argument("--homography", default=None,
                    help="3x3 pixel->meter homography file (plain text, the form the UCY H "
                         "matrices ship in)")
    vs.add_argument("--scale", type=float, default=None,
                    help="meters per pixel (axis-aligned fallback when no homography is "
                         "available)")
    vs.add_argument("--frame-step", type=int, default=10,
                    help="annotation frame grid (default every 10th video frame = 0.4 s)")

    cc = sub.add_parser("cache", help="the kernel build directory (mmtraj_torch/build, or "
                                      "$MMTRAJ_TORCH_BUILD_CACHE): show size, trim, clear")
    cc.add_argument("--clear", action="store_true", help="remove every entry")
    cc.add_argument("--trim-gb", type=float, default=None,
                    help="remove the least recently written entries until the directory is "
                         "under this many GB, sparing the current libraries (default policy "
                         "before a build: MMTRAJ_TORCH_BUILD_CACHE_MAX_GB, else 4)")
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
    """The command line's values over the config's (None leaves a field);
    ``eval`` overrides the data fields, K and the dtype only."""
    a = vars(args)
    train = args.cmd == "train"
    dk = {k: a.get(k) for k in ("data_dir", "scene", "obs_len", "pred_len", "n_max")}
    tk = {k: a.get(k) for k in (
        "steps", "batch_size", "lr", "seed", "lr_schedule", "warmup_steps", "ema_decay",
        "out_dir", "eval_every", "ckpt_every", "weight_decay", "loss", "variety_n",
        "variety_weight", "variety_fde_weight", "steps_per_dispatch")} if train else {}
    tk["k_samples"] = a.get("k")
    mk = {k: a.get(k) for k in (
        "dropout", "num_mixtures", "hidden_dim", "social", "num_heads", "gat_layers", "dtype",
        "adjacency_radius", "encoder", "attn_layers", "remat_policy", "attend_kernel")}
    for flag, field in (("data_parallel", "data_parallel"), ("stream", "stream"),
                        ("augment", "augment_rotate"), ("augment_flip", "augment_rotate"),
                        ("augment_flip", "augment_flip")):
        if train and a.get(flag):
            tk[field] = True
    if a.get("use_pallas"):
        mk["use_pallas"] = True

    def given(d):
        return {k: v for k, v in d.items() if v is not None}

    return cfg.replace(
        model=dataclasses.replace(cfg.model, **given(mk)),
        data=dataclasses.replace(cfg.data, **given(dk)),
        train=dataclasses.replace(cfg.train, **given(tk)),
    )


def _vmap_seeds_guard(parser, args) -> None:
    """--vmap-seeds preconditions (``mmtraj_torch/population.py``'s scope),
    as parser errors before any data or model work; the messages are the
    JAX package's."""
    if args.seeds is None or len(args.seeds) < 2:
        parser.error("--vmap-seeds requires --seeds with >= 2 seeds")
    if args.resume:
        parser.error("--vmap-seeds does not support --resume")
    if args.stream:
        parser.error("--vmap-seeds requires resident ingest (drop --stream)")
    if args.tensorboard:
        parser.error("--vmap-seeds does not write per-seed TensorBoard "
                     "traces (drop --tensorboard; JSONL metrics are still "
                     "written, with per-seed loss rows)")
    if args.profile:
        parser.error("--vmap-seeds does not support --profile (the S-seed "
                     "program interleaves all seeds; profile a single-seed "
                     "run instead)")


def _nan(x):
    """None (a fold with nothing to evaluate) -> NaN, so the tables print."""
    return float("nan") if x is None else x


def _print_loo_seed_table(args, seeds, per_seed) -> None:
    """The multi-seed leave-one-out table: per-scene mean±std over seeds
    (sample std), for the sequential and the ``--vmap-seeds`` protocol."""
    import statistics as _st

    print(f"\nleave-one-out (config {args.config}, "
          f"{len(seeds)} seeds {seeds}): mean ± std over seeds")
    print(f"{'scene':8s} {'ADE(m)':>16s} {'FDE(m)':>16s}")
    avg_a, avg_f = [], []
    for i, scene in enumerate(SCENES):
        a = [_nan(rows[i][1]) for rows in per_seed]
        f = [_nan(rows[i][2]) for rows in per_seed]
        print(f"{scene:8s} {_st.mean(a):8.4f}±{_st.stdev(a):6.4f} "
              f"{_st.mean(f):8.4f}±{_st.stdev(f):6.4f}")
    for rows in per_seed:
        avg_a.append(sum(_nan(r[1]) for r in rows) / len(rows))
        avg_f.append(sum(_nan(r[2]) for r in rows) / len(rows))
    k_any = next((r[3] for rows in per_seed for r in rows if r[1] is not None), None)
    print(f"{'AVG':8s} {_st.mean(avg_a):8.4f}±{_st.stdev(avg_a):6.4f} "
          f"{_st.mean(avg_f):8.4f}±{_st.stdev(avg_f):6.4f} "
          f"(best-of-{k_any})")


def _write_synthetic(cfg) -> None:
    from mmtraj_torch.data.synthetic import write_synthetic_dataset

    write_synthetic_dataset(cfg.data.data_dir, cfg.train.seed)


def _fit_run(cfg, args):
    """``fit`` of one run, with ``--tensorboard``'s logger and inside
    ``--profile``'s trace."""
    from mmtraj_torch import train
    from mmtraj_torch.utils.logging import MetricsLogger
    from mmtraj_torch.utils.profiling import trace_ctx

    logger = MetricsLogger(cfg.train.out_dir, tensorboard=True) if args.tensorboard else None
    try:
        with trace_ctx(cfg.train.out_dir, enabled=args.profile):
            return train.fit(cfg, resume=args.resume, logger=logger, device=args.device)
    finally:
        if logger is not None:
            logger.close()


def _train(args, parser) -> int:
    """One run, or with ``--seeds`` one a seed into ``{out-dir}/s{seed}``
    (sequentially, or as one population with ``--vmap-seeds``), then the
    final metrics, and their mean and spread over seeds.  ``--scene all``:
    the leave-one-out protocol (``_train_loo``)."""
    import statistics

    from mmtraj_torch import population
    from mmtraj_torch.utils.profiling import enable_nan_debugging

    if args.debug_nans:
        enable_nan_debugging()
    if args.vmap_seeds:
        _vmap_seeds_guard(parser, args)
    if args.scene == "all":
        return _train_loo(args)
    seeds = args.seeds if args.seeds else [args.seed]
    finals = []

    def report(seed, result):
        m = result.eval_metrics
        if m:
            finals.append(m)
            tag = f" (seed {seed})" if len(seeds) > 1 else ""
            print(f"final{tag}: best-of-{m['k']} ADE={m['min_ade']:.4f}m "
                  f"FDE={m['min_fde']:.4f}m")

    if args.vmap_seeds:
        args.seed = seeds[0]
        cfg = _apply_overrides(get_config(args.config), args)
        if args.synthetic:
            _write_synthetic(cfg)
        for seed, result in zip(seeds, population.fit_population(cfg, seeds,
                                                                 device=args.device)):
            report(seed, result)
    else:
        base_out = args.out_dir
        for seed in seeds:
            args.seed, args.out_dir = seed, base_out
            cfg = _apply_overrides(get_config(args.config), args)
            if len(seeds) > 1:
                cfg = cfg.replace(train=dataclasses.replace(
                    cfg.train, out_dir=f"{cfg.train.out_dir}/s{seed}"))
            if args.synthetic and seed == seeds[0]:
                _write_synthetic(cfg)
            report(seed, _fit_run(cfg, args))
    if len(finals) > 1:
        a = [m["min_ade"] for m in finals]
        f = [m["min_fde"] for m in finals]
        print(f"over {len(finals)} seeds: ADE={statistics.mean(a):.4f}±{statistics.stdev(a):.4f}m "
              f"FDE={statistics.mean(f):.4f}±{statistics.stdev(f):.4f}m")
    return 0


def _train_loo(args) -> int:
    """The five-fold leave-one-out protocol (``mmtraj/cli.py:536-624``): one
    fold a held-out scene, into ``{out}/{scene}``, or with several seeds
    ``{out}/s{seed}/{scene}``, then the per-scene table and the average;
    with ``--seeds`` the mean±std over seeds, with ``--vmap-seeds`` each
    fold's seeds as one population."""
    from mmtraj_torch import population

    seeds = args.seeds if args.seeds else [args.seed]
    base_out = args.out_dir
    if args.vmap_seeds:
        per_seed = [[] for _ in seeds]
        for scene in SCENES:
            args.scene, args.seed, args.out_dir = scene, seeds[0], base_out
            cfg = _apply_overrides(get_config(args.config), args)
            out = cfg.train.out_dir
            if args.synthetic and scene == SCENES[0]:
                _write_synthetic(cfg)
            results = population.fit_population(cfg, seeds, out_dirs=[f"{out}/s{s}/{scene}"
                                                                      for s in seeds],
                                                device=args.device)
            for i, r in enumerate(results):
                m = r.eval_metrics or {}
                per_seed[i].append((scene, m.get("min_ade"), m.get("min_fde"), m.get("k")))
            print(f"scene={scene}: trained population of {len(seeds)} "
                  f"seeds in one program", flush=True)
        _print_loo_seed_table(args, seeds, per_seed)
        return 0

    per_seed = []
    for seed in seeds:
        args.out_dir = base_out
        rows = []
        for scene in SCENES:
            args.scene, args.seed = scene, seed
            cfg = _apply_overrides(get_config(args.config), args)
            out = cfg.train.out_dir
            sub = f"{out}/{scene}" if len(seeds) == 1 else f"{out}/s{seed}/{scene}"
            cfg = cfg.replace(train=dataclasses.replace(cfg.train, out_dir=sub))
            if args.synthetic and scene == SCENES[0] and seed == seeds[0]:
                _write_synthetic(cfg)
            m = _fit_run(cfg, args).eval_metrics or {}
            rows.append((scene, m.get("min_ade"), m.get("min_fde"), m.get("k")))
        per_seed.append(rows)
        if len(seeds) > 1:
            print(f"\nseed {seed} leave-one-out (config {args.config}):")
            for scene, a, f, _ in rows:
                # a/f are None when a fold had no test windows to evaluate.
                print(f"  {scene:8s} {_nan(a):8.4f} {_nan(f):8.4f}")

    if len(seeds) == 1:
        rows = per_seed[0]
        print(f"\nleave-one-out (config {args.config}):")
        print(f"{'scene':8s} {'ADE(m)':>8s} {'FDE(m)':>8s}")
        ades = [a for _, a, _, _ in rows if a is not None]
        fdes = [f for _, _, f, _ in rows if f is not None]
        for scene, a, f, k in rows:
            print(f"{scene:8s} {_nan(a):8.4f} {_nan(f):8.4f}")
        if ades:
            k_any = next(k for _, a, _, k in rows if a is not None)
            print(f"{'AVG':8s} {sum(ades)/len(ades):8.4f} "
                  f"{sum(fdes)/len(fdes):8.4f} (best-of-{k_any})")
    else:
        _print_loo_seed_table(args, seeds, per_seed)
    return 0


def _eval_loo(args, parser) -> int:
    """Score a ``train --scene all`` tree in one process
    (``mmtraj/cli.py:738-877``): a row a fold and seed, or with
    ``--ensemble`` a row a fold of its pooled members (``evaluate`` on one
    tree's stacked members, ``evaluate_mixed`` across trees), then the
    table of per-scene mean±std (sample std)."""
    import os

    import numpy as np

    from mmtraj_torch import checkpoint
    from mmtraj_torch import evaluate as ev
    from mmtraj_torch.models.forecaster import Forecaster

    name = "checkpoint_ema.npz" if args.ema else "checkpoint.npz"
    trees = args.loo_dir
    if len(trees) > 1 and not args.ensemble:
        parser.error("multiple --loo-dir trees require --ensemble "
                     "(they pool into one heterogeneous ensemble)")
    if args.ensemble and args.rollout != "sample":
        parser.error("--ensemble requires sampled rollouts")
    if args.buckets and len(trees) > 1:
        parser.error("--buckets is not supported on the heterogeneous "
                     "(multi-tree) ensemble path yet — evaluate_mixed "
                     "has no bucket router")

    def tree_seeds(tree):
        # train --scene all writes {out}/{scene} for one seed and
        # {out}/s{seed}/{scene} for several; --seeds applies to every tree.
        sdirs = sorted(int(d[1:]) for d in os.listdir(tree)
                       if d.startswith("s") and d[1:].isdigit())
        if args.seeds is not None:
            missing = [s for s in args.seeds if s not in sdirs]
            if missing:
                found = sdirs if sdirs else "a flat single-seed layout"
                parser.error(
                    f"--seeds {args.seeds} applies to every --loo-dir "
                    f"tree, but {tree!r} has no s{{seed}}/ dirs for "
                    f"{missing} (found: {found})")
            return args.seeds
        return sdirs or [None]

    seeds_by_tree = {tree: tree_seeds(tree) for tree in trees}
    n_members = sum(len(s) for s in seeds_by_tree.values())
    if args.ensemble and n_members < 2:
        parser.error("--ensemble needs >=2 members (a multi-seed tree "
                     "or several --loo-dir trees)")
    protocol = dict(seed=args.seed, reduction=args.reduction, sigma_scale=args.sigma_scale,
                    oversample=args.oversample, tta=args.tta)
    per_scene = {}
    for scene in SCENES:
        ds = None  # the fold's members share its data config: read it once
        members = []
        for tree in trees:
            for seed in seeds_by_tree[tree]:
                sub = f"s{seed}/{scene}" if seed is not None else scene
                ck = checkpoint.load(os.path.join(tree, sub, name))
                cfg = ck.config
                if ds is None:
                    ds = _load_eval_dataset(cfg, False)
                mcfg = (dataclasses.replace(cfg.model, dtype=args.dtype) if args.dtype
                        else cfg.model)
                model = Forecaster(mcfg, cfg.data.obs_len, cfg.data.pred_len,
                                   device=args.device, state=ck.state)
                if args.ensemble:
                    members.append(model)
                    continue
                m = ev.evaluate(model, ck.stats, ds, cfg.train.k_samples, rollout=args.rollout,
                                buckets=args.buckets, **protocol)
                per_scene.setdefault(scene, []).append((m["min_ade"], m["min_fde"]))
                tag = f"seed={seed} " if seed is not None else ""
                print(f"{tag}scene={scene}: ADE={m['min_ade']:.4f} "
                      f"FDE={m['min_fde']:.4f}", flush=True)
        if args.ensemble:
            # A fold's norm stats come from its training data alone, so every
            # member's checkpoint holds the same; the last one's stand for it.
            if len(trees) == 1:
                m = ev.evaluate(members, ck.stats, ds, cfg.train.k_samples,
                                rollout=args.rollout, buckets=args.buckets, **protocol)
            else:
                m = ev.evaluate_mixed(members, ck.stats, ds, cfg.train.k_samples, **protocol)
            per_scene.setdefault(scene, []).append((m["min_ade"], m["min_fde"]))
            print(f"ensemble[{len(members)}] scene={scene}: "
                  f"ADE={m['min_ade']:.4f} FDE={m['min_fde']:.4f}", flush=True)
    k = m["k"]
    extras = "".join(f" {key}={m[key]}"
                     for key in ("oversample", "tta", "sigma_scale", "rollout", "ensemble")
                     if key in m)
    print(f"\nleave-one-out eval (best-of-{k}, {args.reduction}{extras}"
          f"{', EMA' if args.ema else ''}):")
    print(f"{'scene':8s} {'ADE(m)':>16s} {'FDE(m)':>16s}")
    avg_a, avg_f = [], []
    for scene, vals in per_scene.items():
        a = np.array([v[0] for v in vals])
        f = np.array([v[1] for v in vals])
        avg_a.append(a.mean())
        avg_f.append(f.mean())
        # Sample std (ddof=1), as the train --seeds tables; a single row a
        # scene (--ensemble) has no spread.
        if len(a) > 1:
            print(f"{scene:8s} {a.mean():8.4f}±{a.std(ddof=1):6.4f} "
                  f"{f.mean():8.4f}±{f.std(ddof=1):6.4f}")
        else:
            print(f"{scene:8s} {a.mean():8.4f}        "
                  f"{f.mean():8.4f}")
    print(f"{'AVG':8s} {np.mean(avg_a):8.4f}        "
          f"{np.mean(avg_f):8.4f}")
    return 0


def _baseline(args) -> int:
    """Closed-form baseline ADE/FDE on the held-out scene, or with ``--scene
    all`` on every scene and their average; no device."""
    from mmtraj_torch.baselines import evaluate_baseline
    from mmtraj_torch.config import Config
    from mmtraj_torch.data.collate import WindowDataset
    from mmtraj_torch.data.registry import load_scene_windows

    cfg = _apply_overrides(Config(), args)
    scenes = SCENES if args.scene == "all" else (cfg.data.scene,)
    rows = []
    for scene in scenes:
        windows = load_scene_windows(cfg.data.data_dir, scene, cfg.data.obs_len,
                                     cfg.data.pred_len, cfg.data.stride, cfg.data.min_agents)
        # No device shapes to keep: pad to the densest window, so no agent drops.
        n_max = max(cfg.data.n_max, max((w.shape[0] for w in windows), default=1))
        m = evaluate_baseline(WindowDataset(windows, n_max), cfg.data.obs_len, args.baseline)
        rows.append(m)
        print(f"scene={scene} windows={m['n_windows']} "
              f"agents={m['n_agents']}: {args.baseline.upper()} "
              f"ADE={m['min_ade']:.4f}m FDE={m['min_fde']:.4f}m")
    if len(rows) > 1:
        print(f"average over {len(rows)} scenes: "
              f"ADE={sum(m['min_ade'] for m in rows) / len(rows):.4f}m "
              f"FDE={sum(m['min_fde'] for m in rows) / len(rows):.4f}m")
    return 0


def _generate_data(args) -> int:
    from mmtraj_torch.data.synthetic import write_synthetic_dataset

    write_synthetic_dataset(args.data_dir, args.seed, args.n_frames)
    print(f"wrote synthetic scenes {SCENES} to {args.data_dir}")
    return 0


def _profile_stats(args) -> int:
    from mmtraj_torch.utils.profiling import print_trace_summary

    print_trace_summary(args.trace_dir, args.top)
    return 0


def _autotune(args) -> int:
    from mmtraj_torch import checkpoint
    from mmtraj_torch.evaluate import autotune_eval_batch
    from mmtraj_torch.models.forecaster import Forecaster

    ck = checkpoint.load(args.ckpt)
    cfg = ck.config
    model = Forecaster(cfg.model, cfg.data.obs_len, cfg.data.pred_len, device=args.device,
                       state=ck.state)
    best = autotune_eval_batch(model, ck.stats, cfg.data.n_max, args.k or cfg.train.k_samples,
                               iters=args.iters, candidates=args.batches)
    print(f"use: eval --ckpt {args.ckpt} --batch-size {best}")
    return 0


def _convert(args, parser) -> int:
    """The JAX package's ``convert``, between the port's formats."""
    from mmtraj_torch import checkpoint

    if args.keras:
        from mmtraj_torch.interop import load_keras_h5, save_keras_h5

        if args.src.endswith(checkpoint.H5_SUFFIXES):
            # Keras -> the port: Keras's save_weights keeps no config or stats,
            # so they come from the --like checkpoint.
            if not args.like:
                parser.error("--keras import needs --like <ckpt> for config + norm stats")
            donor = checkpoint.load(args.like)
            state = load_keras_h5(args.src, donor.config.model)
            checkpoint.save(args.dst, state, donor.stats, donor.config, donor.step)
        else:
            ck = checkpoint.load(args.src)
            save_keras_h5(args.dst, ck.state, ck.config.model)
        print(f"converted {args.src} -> {args.dst} (keras layout)")
        return 0
    ck = checkpoint.load(args.src)
    checkpoint.save(args.dst, ck.state, ck.stats, ck.config, ck.step)
    print(f"converted {args.src} -> {args.dst} (step={ck.step})")
    return 0


def _export(args, parser) -> int:
    from mmtraj_torch import checkpoint
    from mmtraj_torch.export import export_predictor
    from mmtraj_torch.models.forecaster import Forecaster

    ck = checkpoint.load(args.ckpt)
    cfg = ck.config
    if args.oversample > 1 and cfg.model.head != "gmm":
        # A deterministic head rolls out K*R identical trajectories; selecting
        # among them would bake duplicates into the artifact.
        parser.error("--oversample requires the sampling (GMM) head")
    model = Forecaster(cfg.model, cfg.data.obs_len, cfg.data.pred_len, device=args.device,
                       state=ck.state)
    k = args.k or cfg.train.k_samples
    export_predictor(args.out, model, None, ck.stats, k=k, batch=args.batch,
                     n_agents=cfg.data.n_max, oversample=args.oversample)
    os_tag = f", oversample={args.oversample}" if args.oversample > 1 else ""
    print(f"exported {args.ckpt} -> {args.out} "
          f"(K={k}, batch={args.batch}, N={cfg.data.n_max}{os_tag})")
    return 0


def _serve(args) -> int:
    from mmtraj_torch.serve import serve_lines

    served = serve_lines(args.artifact, sys.stdin, sys.stdout, aggregate=args.aggregate,
                         window_ms=args.window_ms, stats_every=args.stats_every,
                         pipeline_encode=not args.no_pipeline_encode)
    print(f"served {served} request(s)", file=sys.stderr)
    return 0


def _predict(args, parser) -> int:
    """K sampled futures for every window of the held-out scene; window w's
    stream comes from (seed, w) alone (``evaluate.window_stream``), so the
    output does not depend on ``--batch-size``."""
    import numpy as np
    import torch

    from mmtraj_torch import checkpoint
    from mmtraj_torch import evaluate as ev
    from mmtraj_torch.models.forecaster import Forecaster
    from mmtraj_torch.models.sampling import diverse_select

    ck = checkpoint.load(args.ckpt)
    cfg = _apply_overrides(ck.config, args)
    if args.oversample > 1 and cfg.model.head != "gmm":
        parser.error("--oversample requires the sampling (GMM) head")
    ds = _load_eval_dataset(cfg, args.auto_n_max)
    model = Forecaster(cfg.model, cfg.data.obs_len, cfg.data.pred_len, device=args.device,
                       state=ck.state)
    k, to = cfg.train.k_samples, cfg.data.obs_len
    r = k * args.oversample
    bs = args.batch_size or ev.vmem_friendly_batch(
        r, ds.n_max, bytes_per_elem=ev._model_bytes_per_elem(model))
    stats = ev._device_stats(ck.stats, model.device)
    preds = []
    for s in range(0, ds.n_windows, bs):
        idx = np.arange(s, min(s + bs, ds.n_windows))
        xy, mask = ds.batch(idx)
        obs = torch.as_tensor(xy[:, :, :to], device=model.device)
        stream = (ev.window_stream(model, (args.seed, 0, 0), idx, r, ds.n_max)
                  if cfg.model.head == "gmm" else None)
        p = model.rollout_k(obs, torch.as_tensor(mask, device=model.device), stats, r,
                            stream=stream)
        if args.oversample > 1:
            p = diverse_select(p, k)
        preds.append(p.cpu().numpy())
    preds_np = np.concatenate(preds, axis=1)  # (K, W, N, Tp, 2)
    np.savez(args.out, predictions=preds_np, mask=ds.mask, obs_len=to,
             pred_len=cfg.data.pred_len, scene=cfg.data.scene, k=k,
             **({"oversample": args.oversample} if args.oversample > 1 else {}))
    print(f"wrote {args.out}: predictions {preds_np.shape} "
          f"(K={k}, windows={ds.n_windows}, scene={cfg.data.scene})")
    return 0


def visualize_rollouts(ck, cfg, n_windows: int, seed: int, device="cuda", stream=None):
    """``visualize``'s windows and rollouts: ``n_windows`` windows of the
    held-out scene picked as the JAX package picks them
    (``default_rng(seed).choice(..., replace=False)``), K =
    ``cfg.train.k_samples`` rollouts of each by ``Forecaster.rollout_k`` on
    ``device`` with ``cfg.model``'s route and ``ck``'s parameters and stats.
    ``stream``: a pre-drawn (gumbel, normal) as ``rollout_k`` takes it; else
    drawn from a generator seeded with ``seed``.  -> (xy (B, N, To+Tp, 2),
    mask (B, N), rollouts (K, B, N, Tp, 2)) as numpy."""
    import numpy as np
    import torch

    from mmtraj_torch.data.collate import WindowDataset
    from mmtraj_torch.data.registry import load_scene_windows
    from mmtraj_torch.evaluate import _device_stats
    from mmtraj_torch.models.forecaster import Forecaster

    windows = load_scene_windows(cfg.data.data_dir, cfg.data.scene, cfg.data.obs_len,
                                 cfg.data.pred_len, cfg.data.stride, cfg.data.min_agents)
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(windows), size=min(n_windows, len(windows)), replace=False)
    ds = WindowDataset([windows[i] for i in pick], cfg.data.n_max)
    model = Forecaster(cfg.model, cfg.data.obs_len, cfg.data.pred_len, device=device,
                       state=ck.state)
    xy = torch.as_tensor(ds.xy, device=model.device)
    mask = torch.as_tensor(ds.mask, device=model.device)
    generator = None if stream is not None else torch.Generator(model.device).manual_seed(seed)
    rollouts = model.rollout_k(xy[:, :, :cfg.data.obs_len], mask,
                               _device_stats(ck.stats, model.device), cfg.train.k_samples,
                               generator=generator, stream=stream)
    return ds.xy, ds.mask, rollouts.cpu().numpy()


def _visualize(args) -> int:
    from mmtraj_torch import checkpoint
    from mmtraj_torch.utils.viz import render_predictions

    ck = checkpoint.load(args.ckpt)
    cfg = _apply_overrides(ck.config, args)
    xy, mask, rollouts = visualize_rollouts(ck, cfg, args.windows, args.seed, args.device)
    out = render_predictions(args.out, xy, mask, rollouts, cfg.data.obs_len, args.windows)
    print(f"wrote {out} ({len(xy)} windows, K={cfg.train.k_samples}, "
          f"scene={cfg.data.scene})")
    return 0


def _import_obsmat(args) -> int:
    from mmtraj_torch.data.obsmat import convert_obsmat

    n = convert_obsmat(args.src, args.dst)
    print(f"wrote {n} rows: {args.src} -> {args.dst}")
    return 0


def _import_vsp(args, parser) -> int:
    import numpy as np

    from mmtraj_torch.data.vsp import convert_vsp

    if (args.homography is None) == (args.scale is None):
        parser.error("pass exactly one of --homography or --scale")
    H = np.loadtxt(args.homography) if args.homography else None
    n = convert_vsp(args.src, args.dst, homography=H, scale=args.scale,
                    frame_step=args.frame_step)
    print(f"wrote {n} rows: {args.src} -> {args.dst}")
    return 0


def _cache(args, parser) -> int:
    from mmtraj_torch.utils.build_cache import cache_stats, clear_cache, trim_cache

    try:
        if args.clear:
            n, b = clear_cache()
            print(f"cleared {n} entries ({b / 1e6:.1f} MB)")
        elif args.trim_gb is not None:
            n, b = trim_cache(max_bytes=args.trim_gb * 1e9)
            print(f"trimmed {n} entries ({b / 1e6:.1f} MB)")
        s = cache_stats()
    except ValueError as e:  # MMTRAJ_TORCH_BUILD_CACHE set to an "off" value
        parser.error(str(e))
    print(f"cache dir: {s['dir']}\nentries: {s['entries']}\n"
          f"size: {s['total_bytes'] / 1e6:.1f} MB")
    return 0


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if getattr(args, "scene", None) == "all" and args.cmd not in ("train", "baseline"):
        parser.error("--scene all (5-fold leave-one-out) is train/baseline-only")
    if args.cmd == "train":
        return _train(args, parser)
    if args.cmd == "eval-loo":
        return _eval_loo(args, parser)
    if args.cmd == "baseline":
        return _baseline(args)
    if args.cmd == "generate-data":
        return _generate_data(args)
    if args.cmd == "profile-stats":
        return _profile_stats(args)
    if args.cmd == "autotune-eval":
        return _autotune(args)
    if args.cmd == "convert":
        return _convert(args, parser)
    if args.cmd == "export":
        return _export(args, parser)
    if args.cmd == "serve":
        return _serve(args)
    if args.cmd == "predict":
        return _predict(args, parser)
    if args.cmd == "visualize":
        return _visualize(args)
    if args.cmd == "import-obsmat":
        return _import_obsmat(args)
    if args.cmd == "import-vsp":
        return _import_vsp(args, parser)
    if args.cmd == "cache":
        return _cache(args, parser)
    from mmtraj_torch import checkpoint
    from mmtraj_torch.evaluate import evaluate
    from mmtraj_torch.models.forecaster import Forecaster
    from mmtraj_torch.parallel import is_writer, make_mesh

    ck = checkpoint.load(args.ckpt)
    cfg = _apply_overrides(ck.config, args)
    ds = _load_eval_dataset(cfg, args.auto_n_max)
    model = Forecaster(cfg.model, cfg.data.obs_len, cfg.data.pred_len, device=args.device,
                       state=ck.state)
    mesh = make_mesh(device=args.device) if args.data_parallel else None
    m = evaluate(model, ck.stats, ds, cfg.train.k_samples, args.batch_size, args.seed,
                 mesh=mesh, reduction=args.reduction, sigma_scale=args.sigma_scale,
                 rollout=args.rollout, oversample=args.oversample, tta=args.tta,
                 buckets=args.buckets)
    if not is_writer(mesh):
        return 0
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
