#!/usr/bin/env python
"""The zara1 yardstick of the PyTorch port: RESULTS.md's radius-2 quality
recipe on one leave-one-out fold, scored as RESULTS.md scores it, and held to
the JAX package's row.

1. Data: ``cli generate-data --seed 0 --n-frames 600`` (the JAX package's
   files, byte for byte) into ``{workdir}/data``.
2. Training: ``cli train --config 3 --scene zara1 --seeds 0 1 2 3 4
   --vmap-seeds --use-pallas`` with the recipe's flags (``RESULTS.md:14-20``
   plus ``--adjacency-radius 2``, ``RESULTS.md:55-72``): variety n = 8,
   rotate and flip, dropout 0.1, weight decay 1e-4, EMA 0.995, cosine,
   32,000 steps in graphed chunks of 50.  Its output goes to
   ``{workdir}/train.log``.
3. Scoring, on each seed's EMA checkpoint, best-of-20, per agent, on route A
   (``fused_gat`` and ``fused_decode``) and on the plain route:
   - i.i.d.: ``evaluate`` as the training command's end-of-run table runs it
     (the seed's own sampling seed, batch 32); RESULTS.md's i.i.d. column;
   - os-6: ``evaluate(oversample=6)`` with sampling seed 0, as ``eval-loo
     --oversample 6``;
   - ens5: one ``evaluate`` of the 5 members, sampling seed 0, as ``eval-loo
     --ensemble`` on one fold.
   The two routes must agree within 1e-2 m (PERF.md section 2's evaluate
   limit); the tool exits 1 where they do not.
4. The band: the port's mean over seeds minus the JAX package's must be at
   most 2 sqrt(s_port^2 / 5 + s_jax^2 / 5), for ADE and FDE, i.i.d. and os-6
   (sample standard deviations over the 5 seeds); ens5 is held to the os-6
   band.  The JAX rows are ``RESULTS.md:70``.

    python tools/torch_yardstick.py [--workdir runs/yardstick] [--steps 32000]
        [--n-frames 600] [--seeds 0 1 2 3 4] [--device cuda] [--warmup-steps W]

The last line of standard output is one JSON object: the rows, the JAX rows,
each band, the training seconds and ms a population step, and the card's name
and power limit as ``nvidia-smi`` prints them.  Entry points run on the card
unless ``--device cpu`` (a CPU run measures nothing of the card: its JSON
says ``"card": "cpu"``).
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
SCENE = "zara1"
ROUTES = ("A", "plain")
CHUNK = 50  # --steps-per-dispatch
K = 20
OVERSAMPLE = 6
ROUTE_TOL = 1e-2  # meters: route A against plain, each score
# RESULTS.md:70, zara1 of the radius-2 tree (best-of-20, per agent, EMA, 5 seeds):
# (mean, sample std over the seeds) for i.i.d. and os-6; the ensemble's one value.
JAX_ROWS = {
    "iid": {"ade": [0.3817, 0.0031], "fde": [0.5965, 0.0092]},
    "os6": {"ade": [0.3443, 0.0017], "fde": [0.5004, 0.0040]},
    "ens5": {"ade": [0.3414, None], "fde": [0.4972, None]},
}


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


def train_command(data_dir, out_dir, seeds, steps, device, warmup=None):
    """The recipe's ``cli train`` argv; ``warmup`` overrides the cosine
    schedule's warm-up of 100 steps (a run of at most 100 steps needs it)."""
    return (["train", "--config", "3", "--scene", SCENE, "--seeds", *map(str, seeds),
             "--vmap-seeds", "--use-pallas", *RECIPE, "--steps", str(steps),
             "--steps-per-dispatch", str(CHUNK), "--data-dir", data_dir, "--out-dir", out_dir,
             "--device", device] + ([] if warmup is None else ["--warmup-steps", str(warmup)]))


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


def score(run_dir, seeds, route, device):
    """The three rows of one route from the EMA checkpoints under
    ``run_dir/s{seed}`` -> {"iid"|"os6": {"ade"|"fde": [mean, std], "per_seed":
    ...}, "ens5": {"ade"|"fde": [value, None]}, "seconds": ...}."""
    from mmtraj_torch import checkpoint
    from mmtraj_torch.cli import _load_eval_dataset
    from mmtraj_torch.evaluate import evaluate
    from mmtraj_torch.models.forecaster import Forecaster

    t0 = time.perf_counter()
    members, per = [], {"iid": [], "os6": []}
    ds = stats = None
    for seed in seeds:
        ck = checkpoint.load(os.path.join(run_dir, f"s{seed}", "checkpoint_ema.npz"))
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


def bands(rows, n_seeds):
    """Each protocol and metric: the port's mean minus JAX's, and the band
    2 sqrt(s_port^2 / n + s_jax^2 / n) (ens5: os-6's)."""
    out = {}
    for p in ("iid", "os6", "ens5"):
        for m in ("ade", "fde"):
            sp, sj = (rows["os6"][m][1], JAX_ROWS["os6"][m][1]) if p == "ens5" else (
                rows[p][m][1], JAX_ROWS[p][m][1])
            band = 2 * math.sqrt(sp ** 2 / n_seeds + sj ** 2 / n_seeds)
            diff = rows[p][m][0] - JAX_ROWS[p][m][0]
            out[f"{p}_{m}"] = {"diff": diff, "band": band, "within": diff <= band}
    return out


def run(workdir, steps=32000, n_frames=600, seeds=(0, 1, 2, 3, 4), device="cuda", warmup=None,
        log=print) -> dict:
    """The yardstick end to end -> its result (the JSON line's object)."""
    data, run_dir = os.path.join(workdir, "data"), os.path.join(workdir, "run")
    os.makedirs(workdir, exist_ok=True)
    command = train_command(data, run_dir, seeds, steps, device, warmup)
    result = {"card": card_line(device), "device": str(device), "scene": SCENE,
              "seeds": list(seeds), "steps": steps, "n_frames": n_frames,
              "command": " ".join(command)}
    _cli(["generate-data", "--data-dir", data, "--seed", "0", "--n-frames", str(n_frames)])
    t0 = time.perf_counter()
    out = _cli(command, os.path.join(workdir, "train.log"))
    result["train_seconds"] = time.perf_counter() - t0
    log(f"yardstick: trained {len(seeds)} seeds x {steps} steps in "
        f"{result['train_seconds']:.1f} s")
    finals = [ln for ln in out.splitlines() if ln.startswith("final (seed")]
    result["train_table"] = [[float(ln.split("ADE=")[1].split("m")[0]),
                              float(ln.split("FDE=")[1].split("m")[0])] for ln in finals]
    result["step_ms"] = step_ms(os.path.join(run_dir, "metrics.jsonl"))
    result["rows"] = {}
    for route in ROUTES:
        result["rows"][route] = score(run_dir, seeds, route, device)
        r = result["rows"][route]
        log(f"yardstick route {route}: i.i.d. {r['iid']['ade'][0]:.4f}/{r['iid']['fde'][0]:.4f} "
            f"os-6 {r['os6']['ade'][0]:.4f}/{r['os6']['fde'][0]:.4f} ens5 "
            f"{r['ens5']['ade'][0]:.4f}/{r['ens5']['fde'][0]:.4f} ({r['seconds']:.1f} s)")
    result["jax_rows"] = JAX_ROWS
    result["bands"] = {route: bands(r, len(seeds)) for route, r in result["rows"].items()}
    a, b = (result["rows"][r] for r in ROUTES)
    gaps = {f"{p}_{m}": abs(a[p][m][0] - b[p][m][0]) for p in ("iid", "os6", "ens5")
            for m in ("ade", "fde")}
    result["route_gap_m"] = gaps
    result["routes_agree"] = max(gaps.values()) <= ROUTE_TOL
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default="runs/yardstick")
    ap.add_argument("--steps", type=int, default=32000)
    ap.add_argument("--n-frames", type=int, default=600)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--warmup-steps", type=int, default=None,
                    help="the cosine schedule's warm-up (default the recipe's 100)")
    args = ap.parse_args(argv)
    result = run(args.workdir, args.steps, args.n_frames, args.seeds, args.device,
                 args.warmup_steps, log=lambda m: print(m, file=sys.stderr, flush=True))
    line = json.dumps(result)
    with open(os.path.join(args.workdir, "yardstick.json"), "w") as fh:
        fh.write(line + "\n")
    print(line)
    return 0 if result["routes_agree"] else 1


if __name__ == "__main__":
    sys.exit(main())
