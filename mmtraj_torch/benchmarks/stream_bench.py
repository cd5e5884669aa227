"""Streaming-ingest benchmark: resident against streamed training steps/s
(counterpart of ``mmtraj/benchmarks/stream_bench.py``).

It fabricates a window set from ``--seed`` (default 20,000 random-walk
windows at N_max = 64 with 32-64 agents each, about 410 MB of padded host
arrays) and times the same training step (``train.make_train_step``,
config 4 at full width) fed by each of ``fit``'s two ingest paths
(``train.batch_source``):

* resident: the window set on the device, a gather a batch;
* stream: the host's batches of the same permutation through
  ``data.pipeline.prefetch_to_device`` (pinned, copied ahead on a side
  stream, ``--prefetch`` batches in flight).

Both draw the same permutation and the same draws, so the difference is
the ingest's cost.  Each mode runs ``--warmup`` steps, then ``--steps``
steps on the host clock closed by a synchronize.  Prints one JSON line on
stdout (both rates, their ratio, the card's name and power limit); the log
goes to stderr.

Run:  python -m mmtraj_torch.benchmarks.stream_bench --windows 20000 --steps 200
      python -m mmtraj_torch.benchmarks.stream_bench --device cpu --windows 40 --batch 4 \\
          --n-max 8 --steps 2 --warmup 1
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from mmtraj_torch import train
from mmtraj_torch.benchmarks.bench import card_line, sync
from mmtraj_torch.config import config4
from mmtraj_torch.data.collate import WindowDataset
from mmtraj_torch.data.pipeline import DeviceDataset
from mmtraj_torch.data.transforms import NormStats
from mmtraj_torch.models.forecaster import Forecaster


def fabricate_windows(n_windows: int, n_max: int, t_total: int = 20, seed: int = 0):
    """Random-walk windows with univ-like agent counts (n_max/2 to n_max),
    as the JAX package's ``_fabricate_windows`` makes them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_windows):
        n = int(rng.integers(max(1, n_max // 2), n_max + 1))
        steps = rng.normal(scale=0.15, size=(n, t_total, 2)).astype(np.float32)
        out.append(np.cumsum(steps, axis=1)
                   + rng.uniform(0, 12, size=(n, 1, 2)).astype(np.float32))
    return out


def bench_ingest(n_windows: int = 20000, batch_size: int = 256, steps: int = 200,
                 n_max: int = 64, dtype: str = "bfloat16", seed: int = 0, prefetch: int = 2,
                 warmup: int = 3, device="cuda") -> dict:
    """-> {"resident": steps/s, "stream": steps/s, ...} for one training step
    fed by each ingest path in turn."""
    cfg = config4()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dtype=dtype),
                      data=dataclasses.replace(cfg.data, n_max=n_max),
                      train=dataclasses.replace(cfg.train, batch_size=batch_size, seed=seed))
    stats = NormStats(np.zeros(2, np.float32), np.ones(2, np.float32))
    t0 = time.perf_counter()
    ds = WindowDataset(fabricate_windows(n_windows, n_max, cfg.data.obs_len + cfg.data.pred_len,
                                         seed), n_max)
    gib = (ds.xy.nbytes + ds.mask.nbytes) / 2**30
    print(f"fabricated {n_windows} windows (padded host set {gib:.3f} GiB) in "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    out = {"windows": n_windows, "batch": batch_size, "n_max": n_max, "dtype": dtype,
           "prefetch": prefetch, "steps": steps, "host_set_gib": gib}
    for mode in ("resident", "stream"):
        mcfg = cfg.replace(train=dataclasses.replace(cfg.train, stream=mode == "stream"))
        model = Forecaster(cfg.model, cfg.data.obs_len, cfg.data.pred_len, device=device,
                           generator=torch.Generator().manual_seed(seed))
        dev = model.device
        step_fn = train.make_train_step(model, train.make_optimizer(cfg, model), stats,
                                        seed=seed)
        device_ds = DeviceDataset(ds, dev) if mode == "resident" else None
        idx = train.index_stream(device_ds, batch_size, seed) if device_ds else None
        batches = train.batch_source(mcfg, ds, device_ds, idx, 0, 0, dev)
        try:
            for s in range(warmup):
                xy, mask, agents = next(batches)
                loss = step_fn(xy, mask, s, agents)
            float(loss)
            t0 = time.perf_counter()
            for s in range(warmup, warmup + steps):
                xy, mask, agents = next(batches)
                loss = step_fn(xy, mask, s, agents)
            float(loss)
            sync(dev)
            dt = time.perf_counter() - t0
        finally:
            batches.close()
        out[f"{mode}_steps_per_sec"] = steps / dt
        print(f"{mode:9s} B={batch_size} n_max={n_max} {dtype}: {steps / dt:8.3f} steps/s "
              f"({steps * batch_size / dt:10,.1f} windows/s)", file=sys.stderr, flush=True)
    out["stream_over_resident"] = out["stream_steps_per_sec"] / out["resident_steps_per_sec"]
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=20000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--n-max", type=int, default=64)
    ap.add_argument("--dtype", default="bfloat16", choices=("float32", "bfloat16"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefetch", type=int, default=2, help="batches in flight when streamed")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    r = bench_ingest(args.windows, args.batch, args.steps, args.n_max, args.dtype, args.seed,
                     args.prefetch, args.warmup, args.device)
    dev = torch.device(args.device)
    r["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if dev.type == "cuda":
        r["card"] = card_line()
    print(json.dumps(r))


if __name__ == "__main__":
    main()
