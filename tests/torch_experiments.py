"""Shared by the parity tests of the port's experiment scripts
(``tests/test_torch_experiments_*.py``).

* ``train``: a tiny tree through ``python -m mmtraj_torch.cli train`` in
  this process, on the CPU.
* ``run_jax_script``: a JAX script of ``experiments/`` run unchanged with
  ``runpy`` in a scratch working directory (the relative ``runs/`` and
  ``data/synthetic`` it hard-codes resolve there), its ``evaluate`` and
  ``evaluate_mixed`` spied on for the full-precision metrics, in call order.
  JAX reads scenes through ``mmtraj.data.registry``, whose native parser
  races under ``pytest -n``: the caller points its ``read_annotation_file``
  at the numpy parser (the ``numpy_parser`` fixture).
* ``port_report``: a port report's ``report`` with the port's ``evaluate``
  and ``evaluate_mixed`` spied on and JAX's per-window streams handed in
  through ``mmtraj_torch.evaluate.window_stream``.
"""

import contextlib
import io
import os
import re
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

import mmtraj.data.registry as j_registry
import mmtraj.evaluate as j_evaluate
from mmtraj.config import ModelConfig as JModelConfig
from mmtraj.data.parser import read_annotation_file as j_read_annotation_file
from mmtraj.models.forecaster import Forecaster as JForecaster
from mmtraj_torch import evaluate as ev
from mmtraj_torch.cli import main as cli_main
from torch_jax_streams import jax_window_stream

REPO = Path(__file__).resolve().parents[1]
EXPERIMENTS = REPO / "experiments"
sys.path.insert(0, str(EXPERIMENTS))

# The evaluate tolerance of the port fed JAX's streams (as in
# ``tests/test_torch_config3.py``), for metrics of order 1 m; past 1 m
# relative, as float32's spacing grows with the value.
TOL = 1e-6
PRINTED = 5e-5  # a JAX table's number, printed to 4 decimals
KEYS = ("min_ade", "min_fde", "miss_rate_2m", "collision_rate")
# Small widths and short runs for the trees: every run writes checkpoint_ema.npz.
TINY = ["--hidden-dim", "16", "--k", "2", "--batch-size", "8", "--steps", "2",
        "--ema-decay", "0.9", "--device", "cpu"]


@pytest.fixture
def numpy_parser(monkeypatch):
    monkeypatch.setenv("MMTRAJ_COMPILE_CACHE", "off")
    monkeypatch.setattr(j_registry, "read_annotation_file", j_read_annotation_file)


def generate(root, n_frames, name="synthetic"):
    """The synthetic five scenes (seed 0) into ``root/data/{name}``."""
    out = os.path.join(root, "data", name)
    assert cli_main(["generate-data", "--data-dir", out, "--seed", "0",
                     "--n-frames", str(n_frames)]) == 0
    return out


def train(root, out, *flags):
    """``cli train`` of a tiny tree into ``root/out`` on ``root``'s data;
    ``flags`` override ``TINY``'s."""
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli_main(["train", *TINY, *flags, "--data-dir", os.path.join(root, "data",
                                                                           "synthetic"),
                       "--out-dir", os.path.join(root, out)])
    assert rc == 0


def _spy(module, name, seen):
    real = getattr(module, name)

    def spy(*args, **kw):
        m = real(*args, **kw)
        seen.append({k: float(m[k]) for k in KEYS})
        return m

    return spy


def run_jax_script(name, root, monkeypatch, capsys):
    """``experiments/{name}`` run unchanged from ``root`` -> (its metrics, in
    call order; its standard output)."""
    seen = []
    for fn in ("evaluate", "evaluate_mixed"):
        monkeypatch.setattr(j_evaluate, fn, _spy(j_evaluate, fn, seen))
    monkeypatch.chdir(root)
    capsys.readouterr()
    try:
        runpy.run_path(str(EXPERIMENTS / name), run_name="__main__")
    except SystemExit as e:
        assert e.code in (0, None)
    return seen, capsys.readouterr().out


def jax_streams():
    """A stand-in for ``window_stream`` that draws JAX's per-window streams
    for any member: a JAX model of the member's mixtures and horizon."""
    models = {}

    def draw(model, chain, win_idx, k, n, sigma_scale=1.0, draw_n=None):
        key = (model.cfg.num_mixtures, model.obs_len, model.pred_len)
        if key not in models:
            models[key] = jax_window_stream(JForecaster(JModelConfig(num_mixtures=key[0]),
                                                        key[1], key[2]))
        return models[key](model, chain, win_idx, k, n, sigma_scale, draw_n)

    return draw


def port_report(report, monkeypatch, capsys, *args, **kw):
    """``report(*args, **kw)`` fed JAX's streams -> (its tables, its metrics in
    call order, its standard output)."""
    seen = []
    for fn in ("evaluate", "evaluate_mixed"):
        monkeypatch.setattr(ev, fn, _spy(ev, fn, seen))
    monkeypatch.setattr(ev, "window_stream", jax_streams())
    capsys.readouterr()
    out = report(*args, **kw)
    return out, seen, capsys.readouterr().out


def assert_same_metrics(port, jax):
    """Every evaluate call of the port within ``TOL`` of JAX's, call by call."""
    assert len(port) == len(jax) > 0
    for p, j in zip(port, jax):
        np.testing.assert_allclose([p[k] for k in KEYS], [j[k] for k in KEYS], rtol=TOL, atol=TOL)


_NUM = re.compile(r"-?\d+\.\d+")


def row_numbers(text, tag):
    """The decimal numbers of the printed line that starts with ``tag`` (the
    first), after the tag."""
    line = next(ln for ln in text.splitlines() if ln.startswith(tag))
    return [float(x) for x in _NUM.findall(line[len(tag):])]


def assert_rows_match(rows, jax_text):
    """Each port row (``{"route", metric: [mean, std]}``, or None where its
    tree is absent) against the JAX line of its tag: the 8 printed numbers
    within their rounding, or "(missing" where the row is None."""
    for tag, row in rows.items():
        line = next(ln for ln in jax_text.splitlines() if ln.startswith(tag))
        if row is None:
            assert "(missing" in line, (tag, line)
            continue
        want = row_numbers(line, tag)
        assert len(want) == 8, (tag, line)
        for i, k in enumerate(KEYS):
            (mu, sd), (mu_j, sd_j) = row[k], want[2 * i:2 * i + 2]
            tol = PRINTED + TOL * max(1.0, abs(mu_j) + 2 * sd_j)  # the seeds' largest value
            assert abs(mu - mu_j) <= tol and abs(sd - sd_j) <= tol, (tag, k, row[k], want)


# dense_sweep.sh's cells: the tree under runs/r5, the flags of its tiny tree,
# its seeds.  N_max 16 (agents past it are dropped alike on both sides) and
# hidden 32 and N_max 32 standing for cell A's 128 and cell E's 128 keep the
# oversample-6 scoring of the CPU short.  Cell B trains 100 steps at lr 3e-3:
# at initialization a gat_layers=2 model's rollouts diverge in both packages
# (its residual GAT runs twice a frame; min-FDE 80-140 m on these trees), and
# that growth amplifies float32 rounding past any fixed tolerance (0.7% on an
# oversample-6 miss rate); trained, its metrics are of order 1 m, as the
# experiment's are.
DENSE_CELLS = {
    "control": ("dense_control", ["--n-max", "16"], ("0", "1", "2")),
    "A": ("dense_h128_heads4", ["--n-max", "16", "--hidden-dim", "32"], ("0", "1", "2")),
    "B": ("dense_gat2", ["--n-max", "16", "--gat-layers", "2", "--steps", "100", "--lr", "3e-3"],
          ("0", "1", "2")),
    "C": ("dense_rad2", ["--n-max", "16", "--adjacency-radius", "2"], ("0", "1", "2")),
    "D": ("dense_rad8", ["--n-max", "16", "--adjacency-radius", "8"], ("0", "1", "2")),
    "E": ("dense_n128", ["--n-max", "32"], ("0",)),
}


def dense_trees(root, cells, frames):
    """Tiny trees of ``cells`` (the others absent) on a ``frames``-frame tree."""
    generate(str(root), frames)
    for cell in cells:
        tree, flags, seeds = DENSE_CELLS[cell]
        seed_flags = (["--seeds", *seeds, "--vmap-seeds"] if len(seeds) > 1
                      else ["--seed", seeds[0]])
        train(str(root), f"runs/r5/{tree}", "--config", "4", "--scene", "univ", *flags,
              *seed_flags)


def check_dense_report(root, cells, monkeypatch, capsys):
    """The JAX dense-sweep report and the port's on the trees of ``cells``:
    every evaluate call within ``TOL``, every row of both tables within the
    printed rounding, the absent cells "(missing: ...)" on both sides."""
    import torch_dense_sweep_report as report_mod

    jax_seen, jax_out = run_jax_script("dense_sweep_report.py", root, monkeypatch, capsys)
    monkeypatch.chdir(root)
    tables, seen, out = port_report(report_mod.report, monkeypatch, capsys, "runs",
                                    "data/synthetic", "cpu", ("plain",))
    n_evals = sum(len(DENSE_CELLS[c][2]) for c in cells)
    assert len(jax_seen) == 2 * n_evals
    assert_same_metrics(seen, jax_seen)
    iid, os6 = jax_out.split("=== univ fold, oversample-6")
    for key, text in (("iid", iid), ("os6", os6)):
        rows = tables["plain"][key]
        assert len(rows) == len(DENSE_CELLS)
        assert [tag for tag, row in rows.items() if row is not None] == [
            tag for (tag, tree, _), cell in zip(report_mod.CELLS, DENSE_CELLS) if cell in cells]
        assert_rows_match(rows, text)
    assert out.count("(missing: runs/r5/") == 2 * (len(DENSE_CELLS) - len(cells))
    return tables


def mixed_trees(root, rnn_seeds, frames):
    """The trees the mixed-ensemble scripts read, on a ``frames``-frame tree:
    config 3's rnn leave-one-out tree ``runs/r3/loo32k_variety/s{seed}/`` for
    ``rnn_seeds`` and the attention encoder's ``runs/r3/loo32k_attn``: seeds 0
    and 1 in ``s0/``, ``s1/`` and seed 2 in the flat layout, as
    ``mixed_loo.py`` reads it."""
    generate(str(root), frames)
    seeds = ["--seeds", *map(str, rnn_seeds), "--vmap-seeds"]
    train(str(root), "runs/r3/loo32k_variety", "--config", "3", "--scene", "all", *seeds)
    attn = ["--config", "3", "--scene", "all", "--encoder", "attn"]
    train(str(root), "runs/r3/loo32k_attn", *attn, "--seeds", "0", "1", "--vmap-seeds")
    train(str(root), "runs/r3/loo32k_attn", *attn, "--seed", "2")
