"""Tiny overrides that let each cell rehearse on the CPU in seconds."""

import time

TRAIN = {"config.population": 2, "config.train.batch_size": 4, "config.data.n_max": 8,
         "config.train.steps_per_dispatch": 2, "config.train.variety_n": 2,
         "hooks.max_windows": 40}
SERVE = {"config.serve.k": 4, "config.serve.batch": 4, "config.serve.aggregate": 4,
         "config.data.n_max": 16, "traffic.arrivals.rate_per_s": 40, "hooks.max_windows": 200}
TINY = {"c3-population-train": TRAIN, "c4-serve-poisson": SERVE}
SECONDS = {"c3-population-train": 0.3, "c4-serve-poisson": 0.5}


def run(cell, seed=2**31 + 12345, trace=False, device="cpu", **extra):
    from perfcells import harness
    from perfcells.run import run_cell

    spec = harness.load_cell(cell, {**TINY[cell], **extra})
    return run_cell(spec, seed, SECONDS[cell], trace, device, time.perf_counter())
