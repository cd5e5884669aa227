"""The traffic generator.  A traffic mix is a JSON file of parameters in
``perfcells/traffic/<mix>.json``, read by the cell's driver:

- training (``population_train``): ``data_dir``, ``held_out`` (the
  leave-one-out fold: the other scenes train), ``stride``.  Each lane of a
  population walks its own endless stream of epoch permutations, ``batch``
  windows a step.
- requests (``serve_lines``): single-window requests offered on a schedule,
  whatever the server's progress.  ``data_dir``, ``scene`` (the requests'
  windows), ``stats_scenes`` (the normalisation), ``encoding``,
  ``pool_seed`` and ``arrivals``: ``{"kind": <kind>, ...}``, whose shape of
  load over time is ``perfcells/arrivals/<kind>.py`` (``pieces(spec,
  seconds)``: the pieces of constant rate), found by name.

Every seed gets the same work in another order: the inter-arrival gaps are
one multiset a piece, drawn from the mix's ``pool_seed`` and scaled to the
piece's mean, which ``--seed`` permutes; the requests' windows are a
permutation of the scene's; the training batches are permutations of one
window set.  So two seeds differ in what they draw, not in how much they ask.
Every request of a run carries one seed drawn from ``--seed``, so the
server may aggregate them.
"""

from __future__ import annotations

import base64
import importlib.util
import io
import json
import os
from typing import Iterator, List, Tuple

import numpy as np

from perfcells import data

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator of ``seed`` (any whole number) and a stream tag."""
    return np.random.default_rng([int(seed) % 2**64, *stream])


# -- training ---------------------------------------------------------------

def train_windows(mix: dict, obs_len: int, pred_len: int) -> Tuple[list, list]:
    """-> (training windows, held-out windows) of a leave-one-out fold."""
    wins = data.load_windows(os.path.join(ROOT, mix["data_dir"]), data.SCENES, obs_len, pred_len,
                             mix.get("stride", 1))
    train = [w for s in data.SCENES if s != mix["held_out"] for w in wins[s]]
    return train, wins[mix["held_out"]]


def lane_batches(n_windows: int, lanes: int, batch: int, seed: int) -> Iterator[np.ndarray]:
    """Endless (lanes, batch) window indices: lane s takes consecutive
    slices of its own epoch permutations (``seed``, s, epoch); an epoch's
    last short batch is dropped, so no batch repeats a window."""
    per = n_windows // batch
    if per < 1:
        raise ValueError(f"{n_windows} windows cannot fill a batch of {batch}")
    epochs = [0] * lanes
    perms = [rng(seed, 1, s, 0).permutation(n_windows) for s in range(lanes)]
    pos = [0] * lanes
    while True:
        out = np.empty((lanes, batch), np.int64)
        for s in range(lanes):
            if pos[s] + batch > per * batch:
                epochs[s] += 1
                perms[s] = rng(seed, 1, s, epochs[s]).permutation(n_windows)
                pos[s] = 0
            out[s] = perms[s][pos[s]:pos[s] + batch]
            pos[s] += batch
        yield out


# -- requests ---------------------------------------------------------------

def _gaps(n: int, rate: float, pool_seed: int, seed: int) -> np.ndarray:
    g = rng(pool_seed, 2).exponential(1.0, n)
    g *= (n / rate) / g.sum()  # mean exactly 1 / rate
    return rng(seed, 3).permutation(g)


def arrivals_kind(kind: str):
    """The module ``perfcells/arrivals/<kind>.py``."""
    path = os.path.join(ROOT, "perfcells", "arrivals", f"{kind}.py")
    if not os.path.exists(path):
        raise ValueError(f"unknown arrivals kind {kind!r}: no {path}")
    spec = importlib.util.spec_from_file_location(f"perfcells_arrivals_{kind}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def arrivals(spec: dict, seconds: float, pool_seed: int, seed: int) -> np.ndarray:
    """Arrival times in (0, seconds], sorted, for ``spec`` (see the module
    docstring): per piece of constant rate, round(rate x length) arrivals
    whose gaps are a seed's permutation of one fixed multiset."""
    out = []
    for i, (a, b, r) in enumerate(arrivals_kind(spec["kind"]).pieces(spec, seconds)):
        n = int(round(r * (b - a)))
        if n:
            out.append(a + np.cumsum(_gaps(n, n / (b - a), pool_seed + i, seed + i)))
    t = np.concatenate(out) if out else np.zeros(0)
    return np.minimum(np.sort(t), seconds)


def request_pool(mix: dict, obs_len: int, pred_len: int, n_max: int):
    """-> (pool of observed windows (n_i, obs_len, 2), stats (mean, std)):
    the scene's windows, each cut to its ``n_max`` agents closest to its
    centroid as padding would, and the offsets' statistics over
    ``stats_scenes``."""
    scenes = sorted(set([mix["scene"], *mix["stats_scenes"]]))
    wins = data.load_windows(os.path.join(ROOT, mix["data_dir"]), scenes, obs_len, pred_len,
                             mix.get("stride", 1))
    stats = data.norm_stats([w for s in mix["stats_scenes"] for w in wins[s]], obs_len)
    xy, mask = data.pad(wins[mix["scene"]], n_max)
    pool = [xy[i, :int(mask[i].sum()), :obs_len].copy() for i in range(len(xy))]
    return pool, stats


def request_line(xy_obs: np.ndarray, seed: int, encoding: str) -> str:
    """One serve-protocol request line for a single window (no newline)."""
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(xy_obs, np.float32), allow_pickle=False)
    return json.dumps({"xy_b64_npy": base64.b64encode(buf.getvalue()).decode(),
                       "seed": int(seed), "encoding": encoding})


def requests(pool: List[np.ndarray], n: int, seed: int) -> np.ndarray:
    """Which pool window each of ``n`` requests sends: a seed's
    permutations of the pool, one after another."""
    r = rng(seed, 4)
    reps = -(-n // len(pool))
    return np.concatenate([r.permutation(len(pool)) for _ in range(reps)])[:n]
