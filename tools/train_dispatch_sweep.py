"""Training steps/s per step and in chunks of M steps on the card, in turns.

For each loss (nll, variety) and route (plain, ``use_pallas``) at config 4's
full width, times ``train_bench.bench_train_step`` at every
``steps_per_dispatch`` M of ``--m`` and then again in reverse order (M = 1 is
the eager per-step path, M > 1 a CUDA graph of one step replayed M times a
chunk), then profiles the eager step and the graphed step at the largest M
but one (``train_bench.profile_train_step``: ms a step, host enqueue ms,
kernels a step, the device's busy share).  Prints a line a run and, last,
one JSON object with every number and the card's name and power limit.

Run:  python tools/train_dispatch_sweep.py [--batch 16] [--m 1,10,50]
      python tools/train_dispatch_sweep.py --device cpu --batch 2 --n-max 8 --m 1,2
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mmtraj_torch.benchmarks import train_bench  # noqa: E402
from mmtraj_torch.benchmarks.bench import card_line  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--n-max", type=int, default=64)
    ap.add_argument("--m", default="1,10,50", help="steps a dispatch, comma-separated")
    ap.add_argument("--min-seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ms = [int(m) for m in args.m.split(",")]
    card = card_line() if args.device != "cpu" else "cpu"
    print(card, flush=True)
    rates, profiles = {}, {}
    for loss in ("nll", "variety"):
        for use_pallas in (False, True):
            route = "use_pallas" if use_pallas else "plain"
            for m in ms + ms[::-1]:
                r = train_bench.bench_train_step(args.batch, n_max=args.n_max, iters=1,
                                                 use_pallas=use_pallas, loss_mode=loss,
                                                 min_seconds=args.min_seconds,
                                                 device=args.device, flops=False,
                                                 steps_per_dispatch=m)
                rates.setdefault(f"{loss} {route} M={m}", []).append(r.steps_per_sec)
                print(train_bench._fmt(r), flush=True)
            for m in (1, ms[-2] if len(ms) > 2 else ms[-1]):
                p = train_bench.profile_train_step(args.batch, args.n_max, use_pallas, loss,
                                                   device=args.device, steps=max(m, 3),
                                                   steps_per_dispatch=m)
                profiles[f"{loss} {route} M={m}"] = {k: p[k] for k in (
                    "step_ms", "host_enqueue_ms", "device_kernels_per_step",
                    "device_busy_share")}
                print("profile", json.dumps(p), flush=True)
    print(json.dumps({"card": card, "batch": args.batch, "n_max": args.n_max,
                      "steps_per_s": rates, "profiles": profiles}))


if __name__ == "__main__":
    main()
