"""Command-line entry point of the port (counterpart of ``mmtraj/cli.py``).
Ported: ``train`` (one scene; the flags below, with ``--data-parallel``,
``--stream``, ``--seeds`` and ``--vmap-seeds``),
``eval`` (scores a checkpoint on the held-out scene and prints the JAX
package's eval line), ``autotune-eval`` (the fastest eval batch on this
card), ``convert`` (a checkpoint between the .npz, .pt and .h5 formats,
and to and from Keras's legacy ``save_weights`` layout), ``export`` (a
frozen K-sample predictor as a ``torch.export`` .pt2 artifact), ``serve``
(JSON-lines requests on stdin answered from artifacts, protocol in
``mmtraj_torch/serve.py``) and ``predict`` (K sampled futures for every
window of the held-out scene into an .npz).  ``eval``, ``autotune-eval``,
``export`` and ``predict`` read any format ``mmtraj_torch.checkpoint.load``
reads; an Orbax directory is converted with the JAX package's ``python -m
mmtraj.cli convert`` first.

Usage:
  python -m mmtraj_torch.cli train --config 4 --data-dir data/synthetic3000 --out-dir runs/x
  python -m mmtraj_torch.cli train --config 1 --data-dir ... --steps-per-dispatch 10
  python -m mmtraj_torch.cli train --config 4 --data-dir ... --seeds 0 1 2 3 4 --vmap-seeds
  python -m mmtraj_torch.cli train --config 5 --data-dir ... --data-parallel
  python -m mmtraj_torch.cli train --config 4 --data-dir ... --stream
  python -m mmtraj_torch.cli eval --ckpt runs/x/checkpoint.npz --data-dir data/synthetic3000
  python -m mmtraj_torch.cli eval --ckpt runs/x/model.pt --dtype bfloat16
  python -m mmtraj_torch.cli autotune-eval --ckpt runs/x/checkpoint.npz
  python -m mmtraj_torch.cli eval --ckpt ... --data-dir ... --device cpu
  python -m mmtraj_torch.cli eval --ckpt ... --data-dir ... --data-parallel
  python -m mmtraj_torch.cli convert --src runs/x/checkpoint.npz --dst runs/x/model.pt
  python -m mmtraj_torch.cli convert --keras --src runs/x/checkpoint.npz --dst keras.h5
  python -m mmtraj_torch.cli convert --keras --src keras.h5 --like x.npz --dst imported.npz
  python -m mmtraj_torch.cli export --ckpt runs/x/checkpoint.npz --out runs/x/predictor.pt2
  python -m mmtraj_torch.cli serve --artifact runs/x/predictor.pt2 --aggregate 8 < requests.jsonl
  python -m mmtraj_torch.cli predict --ckpt runs/x/checkpoint.npz --out predictions.npz

It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from mmtraj_torch.config import SCENES, get_config


def _add_train(sub) -> None:
    tp = sub.add_parser("train", help="train a forecaster on one device")
    tp.add_argument("--config", default="3", help="preset 1..5")
    tp.add_argument("--data-dir", default=None, help="annotation dir ({scene}.txt files)")
    tp.add_argument("--scene", default=None, choices=SCENES, help="held-out scene")
    tp.add_argument("--k", type=int, default=None, help="K samples for best-of-K eval")
    tp.add_argument("--obs-len", type=int, default=None)
    tp.add_argument("--pred-len", type=int, default=None)
    tp.add_argument("--n-max", type=int, default=None, help="padded agent capacity")
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
                         "mean±std (e.g. --seeds 0 1 2)")
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
    tp.add_argument("--device", default="cuda", help="torch device (default cuda)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="mmtraj_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    _add_train(sub)
    ep = sub.add_parser("eval", help="evaluate a checkpoint (best-of-K ADE/FDE)")
    ep.add_argument("--ckpt", required=True,
                    help="a .npz, .pt or .h5 checkpoint (either package's)")
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

    cp = sub.add_parser("convert", help="convert a checkpoint between formats (.npz / .pt / .h5)")
    cp.add_argument("--src", required=True, help="source checkpoint path")
    cp.add_argument("--dst", required=True, help="destination path; the suffix picks the format")
    cp.add_argument("--keras", action="store_true",
                    help="treat .h5 files as Keras's legacy save_weights layout (reference "
                         "layer names, mmtraj_torch/interop.py) instead of the flat h5; weights "
                         "only, so a Keras --src needs --like for the config and norm stats")
    cp.add_argument("--like", default=None,
                    help="with --keras and a Keras --src: the checkpoint whose config and norm "
                         "stats the Keras weights belong to")

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
    rp.add_argument("--data-dir", default=None, help="annotation dir ({scene}.txt files)")
    rp.add_argument("--scene", default=None, choices=SCENES, help="held-out scene")
    rp.add_argument("--k", type=int, default=None, help="K samples")
    rp.add_argument("--obs-len", type=int, default=None)
    rp.add_argument("--pred-len", type=int, default=None)
    rp.add_argument("--n-max", type=int, default=None, help="padded agent capacity")
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


def _train(args, parser) -> int:
    """One run, or with ``--seeds`` one a seed into ``{out-dir}/s{seed}``
    (sequentially, or as one population with ``--vmap-seeds``), then the
    final metrics, and their mean and spread over seeds."""
    import statistics

    from mmtraj_torch.train import fit

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
        from mmtraj_torch.population import fit_population

        _vmap_seeds_guard(parser, args)
        args.seed = seeds[0]
        cfg = _apply_overrides(get_config(args.config), args)
        for seed, result in zip(seeds, fit_population(cfg, seeds, device=args.device)):
            report(seed, result)
    else:
        base_out = args.out_dir
        for seed in seeds:
            args.seed, args.out_dir = seed, base_out
            cfg = _apply_overrides(get_config(args.config), args)
            if len(seeds) > 1:
                cfg = cfg.replace(train=dataclasses.replace(
                    cfg.train, out_dir=f"{cfg.train.out_dir}/s{seed}"))
            report(seed, fit(cfg, resume=args.resume, device=args.device))
    if len(finals) > 1:
        a = [m["min_ade"] for m in finals]
        f = [m["min_fde"] for m in finals]
        print(f"over {len(finals)} seeds: ADE={statistics.mean(a):.4f}±{statistics.stdev(a):.4f}m "
              f"FDE={statistics.mean(f):.4f}±{statistics.stdev(f):.4f}m")
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


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.cmd == "train":
        return _train(args, parser)
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
