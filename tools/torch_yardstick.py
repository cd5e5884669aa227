#!/usr/bin/env python
"""The radius-2 yardstick of the PyTorch port: RESULTS.md's quality recipe on
leave-one-out folds, scored as RESULTS.md scores them, and held to the JAX
package's rows.

1. Data: ``cli generate-data --seed 0 --n-frames 600`` (the JAX package's
   files, byte for byte) into ``{workdir}/data``.
2. Training, a fold at a time: ``cli train --config 3 --scene {scene}
   --seeds 0 1 2 3 4 --vmap-seeds --use-pallas`` with the recipe's flags
   (``RESULTS.md:14-20`` plus ``--adjacency-radius 2``, ``RESULTS.md:55-72``):
   variety n = 8, rotate and flip, dropout 0.1, weight decay 1e-4, EMA 0.995,
   cosine, 32,000 steps in graphed chunks of 50.  Each fold's seeds are one
   population whose checkpoints go to ``{workdir}/s{seed}/{scene}/``, the
   tree ``train --scene all --vmap-seeds`` writes, so that ``cli eval-loo
   --loo-dir {workdir} --ema [--oversample 6 | --ensemble]`` scores it once
   all five folds are in it.  A fold's log is ``{workdir}/train_{scene}.log``,
   its metrics ``{workdir}/logs/{scene}/metrics.jsonl``.
3. Scoring, on each seed's EMA checkpoint, best-of-20, per agent, on route A
   (``fused_gat`` and ``fused_decode``) and on the plain route:
   - i.i.d.: ``evaluate`` as the training command's end-of-run table runs it
     (the seed's own sampling seed, batch 32); RESULTS.md's i.i.d. column;
   - os-6: ``evaluate(oversample=6)`` with sampling seed 0, as ``eval-loo
     --oversample 6``;
   - ens5: one ``evaluate`` of the 5 members, sampling seed 0, as ``eval-loo
     --ensemble``.
   The two routes must agree within 1e-2 m (PERF.md section 2's evaluate
   limit); the tool exits 1 where they do not.
4. The band: the port's mean over seeds minus the JAX package's must be at
   most 2 sqrt(s_port^2 / 5 + s_jax^2 / 5), for ADE and FDE, i.i.d. and os-6
   (sample standard deviations over the 5 seeds); ens5 is held to the os-6
   band.  ``within`` is that one-sided test; ``within_two_sided`` also asks
   that the port lie no further below.  The JAX rows are ``RESULTS.md:67-72``.
5. The average: once ``{workdir}/yardstick_{scene}.json`` exists for all
   five folds (this run's or an earlier one's), the five-fold average
   against ``RESULTS.md:72``: a seed's value is its mean over the folds, and
   the band comes from those five values as for one fold.  RESULTS.md gives
   the os-6 average no spread, so its band rests on the port's alone.
   ``--report`` trains nothing and prints the average of the five files
   under ``--workdir`` (folds trained in separate runs; the H100's are in
   ``docs/torch_yardstick/``).

    python tools/torch_yardstick.py [--workdir runs/yardstick] [--scene zara1 |
        univ zara2 ... | all] [--steps 32000] [--n-frames 600]
        [--seeds 0 1 2 3 4] [--device cuda] [--warmup-steps W]
    python tools/torch_yardstick.py --report --workdir docs/torch_yardstick

Each fold prints one JSON line as it finishes (also written to
``{workdir}/yardstick_{scene}.json``): the rows with each seed's values, the
JAX rows, each band, the training seconds and ms a population step, and the
card's name and power limit as ``nvidia-smi`` prints them.  The average's
line follows where there is one.  The last line (also
``{workdir}/yardstick.json``) is the average's, else the last fold's.
Entry points run on the card unless ``--device cpu`` (a CPU run measures
nothing of the card: its JSON says ``"card": "cpu"``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

RECIPE = ["--loss", "variety", "--variety-n", "8", "--augment", "--augment-flip", "--dropout",
          "0.1", "--weight-decay", "1e-4", "--ema-decay", "0.995", "--lr-schedule", "cosine",
          "--adjacency-radius", "2"]
SCENES = ("eth", "hotel", "univ", "zara1", "zara2")  # mmtraj_torch.config.SCENES
SCENE = "zara1"
ROUTES = ("A", "plain")
PROTOCOLS = ("iid", "os6", "ens5")
CHUNK = 50  # --steps-per-dispatch
K = 20
OVERSAMPLE = 6
ROUTE_TOL = 1e-2  # meters: route A against plain, each score


def _row(iid, os6, ens5):
    """A RESULTS.md row: (mean, sample std over the 5 seeds) for i.i.d. and
    os-6, ADE then FDE; the ensemble's one value each."""
    return {"iid": {"ade": list(iid[0]), "fde": list(iid[1])},
            "os6": {"ade": list(os6[0]), "fde": list(os6[1])},
            "ens5": {"ade": [ens5[0], None], "fde": [ens5[1], None]}}


# RESULTS.md:67-72, the radius-2 tree (best-of-20, per agent, EMA, 5 seeds).
# The average's os-6 row has no spread there (None).
JAX_ROWS_BY_SCENE = {
    "eth": _row(((0.3309, 0.0032), (0.5179, 0.0064)), ((0.3004, 0.0015), (0.4429, 0.0027)),
                (0.2997, 0.4329)),
    "hotel": _row(((0.3115, 0.0011), (0.5035, 0.0044)), ((0.2842, 0.0019), (0.4353, 0.0065)),
                  (0.2847, 0.4272)),
    "univ": _row(((0.5337, 0.0024), (0.8020, 0.0027)), ((0.4696, 0.0022), (0.6360, 0.0028)),
                 (0.4660, 0.6270)),
    "zara1": _row(((0.3817, 0.0031), (0.5965, 0.0092)), ((0.3443, 0.0017), (0.5004, 0.0040)),
                  (0.3414, 0.4972)),
    "zara2": _row(((0.3946, 0.0022), (0.6101, 0.0029)), ((0.3538, 0.0020), (0.5074, 0.0040)),
                  (0.3526, 0.5059)),
    "average": _row(((0.3905, 0.0013), (0.6060, 0.0019)), ((0.3504, None), (0.5044, None)),
                    (0.3489, 0.4980)),
}
JAX_ROWS = JAX_ROWS_BY_SCENE[SCENE]


def _cli(argv, log_path=None) -> str:
    """A ``mmtraj_torch.cli`` command in this process; its standard output,
    also written to ``log_path``.  Raises on a nonzero exit."""
    from mmtraj_torch.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(list(argv))
    out = buf.getvalue()
    if log_path:
        with open(log_path, "w") as fh:
            fh.write(out)
    if rc != 0:
        raise RuntimeError(f"cli {argv[0]} exited {rc}:\n{out[-4000:]}")
    return out


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi prints them; "cpu" for
    a CPU run."""
    if str(device).startswith("cpu"):
        return "cpu"
    from mmtraj_torch.benchmarks.bench import card_line as smi

    return smi()


def train_command(data_dir, out_dir, seeds, steps, device, warmup=None, scene=SCENE):
    """The recipe's ``cli train`` argv; ``warmup`` overrides the cosine
    schedule's warm-up of 100 steps (a run of at most 100 steps needs it)."""
    return (["train", "--config", "3", "--scene", scene, "--seeds", *map(str, seeds),
             "--vmap-seeds", "--use-pallas", *RECIPE, "--steps", str(steps),
             "--steps-per-dispatch", str(CHUNK), "--data-dir", data_dir, "--out-dir", out_dir,
             "--device", device] + ([] if warmup is None else ["--warmup-steps", str(warmup)]))


def train_fold(command, tree, scene, seeds, log_dir, device):
    """``command`` (a ``train --scene {scene} --vmap-seeds`` argv) run as
    ``train --scene all --vmap-seeds`` runs one fold (``mmtraj_torch/cli.py``
    ``_train_loo``): one population whose seed s writes ``{tree}/s{s}/{scene}``,
    its metrics into ``log_dir`` -> the ``TrainResult`` a seed."""
    from mmtraj_torch import population
    from mmtraj_torch.cli import _apply_overrides, _vmap_seeds_guard, build_parser
    from mmtraj_torch.config import get_config
    from mmtraj_torch.utils.logging import MetricsLogger

    parser = build_parser()
    args = parser.parse_args(command)
    _vmap_seeds_guard(parser, args)
    args.seed = seeds[0]
    cfg = _apply_overrides(get_config(args.config), args)
    return population.fit_population(
        cfg, seeds, out_dirs=[os.path.join(tree, f"s{s}", scene) for s in seeds],
        logger=MetricsLogger(log_dir), device=device)


def step_ms(metrics_path) -> float:
    """ms a population step between the first and the last logged step
    (steps 1 and log_every include the chunk's capture; later chunks are
    replays), from the run's ``metrics.jsonl``; None with fewer than two
    logged steps past the first chunk."""
    rows = [json.loads(ln) for ln in open(metrics_path)]
    rows = [r for r in rows if "loss_per_seed" in r and r["step"] > CHUNK]
    if len(rows) < 2:
        return None
    return 1e3 * (rows[-1]["t"] - rows[0]["t"]) / (rows[-1]["step"] - rows[0]["step"])


def _mean_std(xs):
    return [statistics.mean(xs), statistics.stdev(xs) if len(xs) > 1 else 0.0]


def score(tree, scene, seeds, route, device):
    """The three rows of one route from the EMA checkpoints under
    ``tree/s{seed}/{scene}`` -> {"iid"|"os6": {"ade"|"fde": [mean, std],
    "per_seed": ...}, "ens5": {"ade"|"fde": [value, None]}, "seconds": ...}."""
    from mmtraj_torch import checkpoint
    from mmtraj_torch.cli import _load_eval_dataset
    from mmtraj_torch.evaluate import evaluate
    from mmtraj_torch.models.forecaster import Forecaster

    t0 = time.perf_counter()
    members, per = [], {"iid": [], "os6": []}
    ds = stats = None
    for seed in seeds:
        ck = checkpoint.load(os.path.join(tree, f"s{seed}", scene, "checkpoint_ema.npz"))
        cfg = ck.config
        flags = (dict(use_pallas=True, use_fused_decoder=True) if route == "A"
                 else dict(use_pallas=False, use_fused_decoder=False, attend_kernel="xla"))
        model = Forecaster(dataclasses.replace(cfg.model, **flags), cfg.data.obs_len,
                           cfg.data.pred_len, device=device, state=ck.state)
        if ds is None:
            ds, stats = _load_eval_dataset(cfg, False), ck.stats
        m = evaluate(model, ck.stats, ds, K, batch_size=min(cfg.train.batch_size, 64), seed=seed)
        per["iid"].append((m["min_ade"], m["min_fde"]))
        m = evaluate(model, ck.stats, ds, K, seed=0, oversample=OVERSAMPLE)
        per["os6"].append((m["min_ade"], m["min_fde"]))
        members.append(model)
    rows = {p: {"ade": _mean_std([a for a, _ in v]), "fde": _mean_std([f for _, f in v]),
                "per_seed": [[a, f] for a, f in v]} for p, v in per.items()}
    m = evaluate(members, stats, ds, K, seed=0)
    rows["ens5"] = {"ade": [m["min_ade"], None], "fde": [m["min_fde"], None]}
    rows["windows"], rows["agents"] = m["n_windows"], m["n_agents"]
    rows["seconds"] = time.perf_counter() - t0
    return rows


def bands(rows, n_seeds, jax_rows=None):
    """Each protocol and metric: the port's mean minus JAX's, and the band
    2 sqrt(s_port^2 / n + s_jax^2 / n) (ens5: os-6's; a JAX spread that
    RESULTS.md does not give counts as 0); ``within`` is the one-sided test
    (diff <= band), ``within_two_sided`` |diff| <= band."""
    jax_rows = JAX_ROWS if jax_rows is None else jax_rows
    out = {}
    for p in PROTOCOLS:
        for m in ("ade", "fde"):
            q = "os6" if p == "ens5" else p
            sp, sj = rows[q][m][1], jax_rows[q][m][1] or 0.0
            band = 2 * math.sqrt(sp ** 2 / n_seeds + sj ** 2 / n_seeds)
            diff = rows[p][m][0] - jax_rows[p][m][0]
            out[f"{p}_{m}"] = {"diff": diff, "band": band, "within": diff <= band,
                               "within_two_sided": abs(diff) <= band}
    return out


def route_gaps(rows):
    """Each score's |route A - plain| -> ({key: gap}, whether every gap is
    within ``ROUTE_TOL``)."""
    a, b = (rows[r] for r in ROUTES)
    gaps = {f"{p}_{m}": abs(a[p][m][0] - b[p][m][0]) for p in PROTOCOLS for m in ("ade", "fde")}
    return gaps, max(gaps.values()) <= ROUTE_TOL


def average(folds) -> dict:
    """The five-fold average of fold results (``run_fold``'s, one a scene of
    ``SCENES``) against ``RESULTS.md:72``: a seed's i.i.d. and os-6 value is
    its mean over the folds, the row their mean and sample std; ens5 the
    mean of the folds' ensembles."""
    by = {f["scene"]: f for f in folds}
    if sorted(by) != sorted(SCENES):
        raise ValueError(f"the average needs the five folds {SCENES}, got {sorted(by)}")
    seeds = by[SCENES[0]]["seeds"]
    if any(by[s]["seeds"] != seeds for s in SCENES):
        raise ValueError("the folds were trained on different seeds")
    rows = {}
    for route in ROUTES:
        r = {}
        for p in ("iid", "os6"):
            per = [[statistics.mean(by[s]["rows"][route][p]["per_seed"][i][j] for s in SCENES)
                    for j in (0, 1)] for i in range(len(seeds))]
            r[p] = {"ade": _mean_std([a for a, _ in per]), "fde": _mean_std([f for _, f in per]),
                    "per_seed": per}
        r["ens5"] = {m: [statistics.mean(by[s]["rows"][route]["ens5"][m][0] for s in SCENES),
                         None] for m in ("ade", "fde")}
        rows[route] = r
    jax_rows = JAX_ROWS_BY_SCENE["average"]
    gaps, agree = route_gaps(rows)
    return {"scene": "average", "card": by[SCENES[0]]["card"], "seeds": seeds,
            "folds": {s: by[s].get("command") for s in SCENES}, "rows": rows,
            "jax_rows": jax_rows,
            "bands": {route: bands(r, len(seeds), jax_rows) for route, r in rows.items()},
            "route_gap_m": gaps, "routes_agree": agree}


def run_fold(workdir, scene, steps, n_frames, seeds, device, warmup, log) -> dict:
    """One fold end to end on the data under ``{workdir}/data`` -> its result
    (the fold's JSON line's object)."""
    data = os.path.join(workdir, "data")
    command = train_command(data, workdir, seeds, steps, device, warmup, scene)
    jax_rows = JAX_ROWS_BY_SCENE[scene]
    result = {"card": card_line(device), "device": str(device), "scene": scene,
              "seeds": list(seeds), "steps": steps, "n_frames": n_frames,
              "command": " ".join(command)}
    log_dir = os.path.join(workdir, "logs", scene)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        results = train_fold(command, workdir, scene, seeds, log_dir, device)
    result["train_seconds"] = time.perf_counter() - t0
    with open(os.path.join(workdir, f"train_{scene}.log"), "w") as fh:
        fh.write(buf.getvalue())
    log(f"yardstick {scene}: trained {len(seeds)} seeds x {steps} steps in "
        f"{result['train_seconds']:.1f} s")
    # The training command's end-of-run table, as it prints it (4 decimals).
    result["train_table"] = [[round(r.eval_metrics["min_ade"], 4),
                              round(r.eval_metrics["min_fde"], 4)] for r in results]
    result["step_ms"] = step_ms(os.path.join(log_dir, "metrics.jsonl"))
    result["rows"] = {}
    for route in ROUTES:
        result["rows"][route] = score(workdir, scene, seeds, route, device)
        r = result["rows"][route]
        log(f"yardstick {scene} route {route}: i.i.d. {r['iid']['ade'][0]:.4f}/"
            f"{r['iid']['fde'][0]:.4f} os-6 {r['os6']['ade'][0]:.4f}/{r['os6']['fde'][0]:.4f} "
            f"ens5 {r['ens5']['ade'][0]:.4f}/{r['ens5']['fde'][0]:.4f} ({r['seconds']:.1f} s)")
    result["jax_rows"] = jax_rows
    result["bands"] = {route: bands(r, len(seeds), jax_rows)
                       for route, r in result["rows"].items()}
    result["route_gap_m"], result["routes_agree"] = route_gaps(result["rows"])
    return result


def fold_path(workdir, scene) -> str:
    return os.path.join(workdir, f"yardstick_{scene}.json")


def run_folds(workdir, scenes=(SCENE,), steps=32000, n_frames=600, seeds=(0, 1, 2, 3, 4),
              device="cuda", warmup=None, log=print, emit=None) -> list:
    """The folds ``scenes`` one after another into the tree ``workdir``
    (``emit`` gets each fold's result as it finishes), then the average where
    ``yardstick_{scene}.json`` exists for every fold -> the results, the
    average last where there is one."""
    os.makedirs(workdir, exist_ok=True)
    _cli(["generate-data", "--data-dir", os.path.join(workdir, "data"), "--seed", "0",
          "--n-frames", str(n_frames)])
    out = []
    for scene in scenes:
        res = run_fold(workdir, scene, steps, n_frames, seeds, device, warmup, log)
        with open(fold_path(workdir, scene), "w") as fh:
            fh.write(json.dumps(res) + "\n")
        out.append(res)
        if emit:
            emit(res)
    if all(os.path.exists(fold_path(workdir, s)) for s in SCENES):
        res = average([json.load(open(fold_path(workdir, s))) for s in SCENES])
        out.append(res)
        if emit:
            emit(res)
    return out


def run(workdir, steps=32000, n_frames=600, seeds=(0, 1, 2, 3, 4), device="cuda", warmup=None,
        log=print, scene=SCENE) -> dict:
    """One fold of the yardstick end to end -> its result (its JSON line's
    object)."""
    return run_folds(workdir, (scene,), steps, n_frames, seeds, device, warmup, log)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default="runs/yardstick")
    ap.add_argument("--scene", nargs="+", default=[SCENE], choices=SCENES + ("all",),
                    help="the held-out folds, one after another, or all (default zara1)")
    ap.add_argument("--steps", type=int, default=32000)
    ap.add_argument("--n-frames", type=int, default=600)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--warmup-steps", type=int, default=None,
                    help="the cosine schedule's warm-up (default the recipe's 100)")
    ap.add_argument("--report", action="store_true",
                    help="train nothing: print the average of the five yardstick_{scene}.json "
                         "under --workdir (folds trained in separate runs)")
    args = ap.parse_args(argv)
    if args.report:
        result = average([json.load(open(fold_path(args.workdir, s))) for s in SCENES])
        print(json.dumps(result))
        return 0 if result["routes_agree"] else 1
    scenes = SCENES if "all" in args.scene else tuple(args.scene)
    results = run_folds(args.workdir, scenes, args.steps, args.n_frames, args.seeds, args.device,
                        args.warmup_steps, log=lambda m: print(m, file=sys.stderr, flush=True),
                        emit=lambda r: print(json.dumps(r), flush=True))
    with open(os.path.join(args.workdir, "yardstick.json"), "w") as fh:
        fh.write(json.dumps(results[-1]) + "\n")
    return 0 if all(r["routes_agree"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
