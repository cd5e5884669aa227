"""The leave-one-out protocol of the port against the JAX package, on the CPU.

``train --scene all``: both CLIs run with ``fit`` and ``fit_population``
replaced by recorders that return fixed metrics, so the fold plan (held-out
scene, seed, out dir, steps, the data written by ``--synthetic``) and the
printed tables are compared without training: single seed, ``--seeds 0 1``
and ``--vmap-seeds``.  The guards print the JAX package's messages.

``eval-loo``: trees of JAX-initialised checkpoints in both layouts
(``{scene}/`` and ``s{seed}/{scene}/``), no training.  The port, fed JAX's
per-window streams through ``mmtraj_torch.evaluate.window_stream``, gives
each fold's metrics within 1e-6 of JAX's ``eval-loo`` and the same text with
the numbers masked: plain, ``--oversample 2``, ``--ensemble`` and two trees
with ``--ensemble``.  JAX's CLI reads scenes through
``mmtraj.data.registry``, whose native parser races under ``pytest -n``; the
tests point its ``read_annotation_file`` at JAX's numpy parser.
"""

import filecmp
import re

import jax
import numpy as np
import pytest
import torch

import mmtraj.data.registry as j_registry
import mmtraj.evaluate as j_evaluate_mod
import mmtraj.population as j_population
import mmtraj.train as j_train
from mmtraj import checkpoint as j_checkpoint
from mmtraj import cli as j_cli
from mmtraj.config import SCENES
from mmtraj.config import Config as JConfig
from mmtraj.config import DataConfig as JDataConfig
from mmtraj.config import ModelConfig as JModelConfig
from mmtraj.config import TrainConfig as JTrainConfig
from mmtraj.data.parser import read_annotation_file as j_read_annotation_file
from mmtraj.data.transforms import NormStats as JNormStats
from mmtraj.models.forecaster import Forecaster as JForecaster
from mmtraj_torch import cli
from mmtraj_torch import evaluate as ev
from mmtraj_torch import population
from mmtraj_torch import train
from torch_jax_streams import SMALL, TO, TP, jax_window_stream, write_scenes

torch.set_num_threads(2)

K = 3
FOLD_TOL = 1e-6


@pytest.fixture(autouse=True)
def _numpy_parser(monkeypatch):
    monkeypatch.setenv("MMTRAJ_COMPILE_CACHE", "off")
    monkeypatch.setattr(j_registry, "read_annotation_file", j_read_annotation_file)


# -- train --scene all ----------------------------------------------------------


class _Result:
    def __init__(self, metrics):
        self.eval_metrics = metrics


def _metrics(scene, seed, empty):
    """Fixed metrics of a fold; a scene in ``empty`` has nothing to evaluate."""
    if scene in empty:
        return {}
    i = SCENES.index(scene)
    return {"min_ade": 0.3 + 0.05 * i + 0.013 * seed, "min_fde": 0.6 + 0.07 * i + 0.029 * seed,
            "k": 20}


def _recorders(plan, empty):
    def fit(cfg, *args, **kw):
        plan.append(("fit", cfg.data.scene, cfg.train.seed, cfg.train.out_dir, cfg.train.steps))
        return _Result(_metrics(cfg.data.scene, cfg.train.seed, empty))

    def fit_population(cfg, seeds, *args, out_dirs=None, **kw):
        plan.append(("pop", cfg.data.scene, tuple(seeds), tuple(out_dirs), cfg.train.steps))
        return [_Result(_metrics(cfg.data.scene, s, empty)) for s in seeds]

    return fit, fit_population


def _run_train(main, fit_mod, pop_mod, argv, empty, monkeypatch, capsys):
    plan = []
    fit, fit_population = _recorders(plan, empty)
    monkeypatch.setattr(fit_mod, "fit", fit)
    monkeypatch.setattr(pop_mod, "fit_population", fit_population)
    assert main(argv) == 0
    return plan, capsys.readouterr().out


# A fold with nothing to evaluate prints NaN in the single-seed table; the
# multi-seed table's statistics.stdev raises on NaN in both packages, so those
# cases give every fold metrics.
@pytest.mark.parametrize("flags, empty", [
    ([], {"zara2"}),
    (["--seeds", "0", "1"], set()),
    (["--seeds", "0", "1", "--vmap-seeds"], set()),
], ids=["one-seed", "seeds", "vmap-seeds"])
def test_train_scene_all_plan_and_tables_match_jax(flags, empty, tmp_path, monkeypatch, capsys):
    argv = ["train", "--config", "4", "--scene", "all", "--steps", "7", "--synthetic"] + flags
    runs = {}
    for name, main, fit_mod, pop_mod, extra in (
            ("jax", j_cli.main, j_train, j_population, []),
            ("port", cli.main, train, population, ["--device", "cpu"])):
        data = tmp_path / name / "data"
        out = str(tmp_path / "runs")  # one out dir, so the plans compare as they are
        runs[name] = _run_train(main, fit_mod, pop_mod,
                                argv + ["--data-dir", str(data), "--out-dir", out] + extra,
                                empty, monkeypatch, capsys) + (data,)
    (j_plan, j_out, j_data), (p_plan, p_out, p_data) = runs["jax"], runs["port"]
    assert p_plan == j_plan and len(p_plan) == (5 if "--vmap-seeds" in flags else
                                                5 * (1 + ("--seeds" in flags)))
    assert p_out == j_out
    assert ("nan" in p_out) == bool(empty) and "leave-one-out (config 4" in p_out
    for scene in SCENES:  # --synthetic wrote the same dataset
        assert filecmp.cmp(j_data / f"{scene}.txt", p_data / f"{scene}.txt", shallow=False)


def _error_line(main, argv, capsys):
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 2
    return capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1]


@pytest.mark.parametrize("argv", [
    ["train", "--scene", "all", "--vmap-seeds"],
    ["train", "--scene", "all", "--seeds", "0", "1", "--vmap-seeds", "--resume"],
    ["train", "--seeds", "0", "1", "--vmap-seeds", "--stream"],
    ["train", "--scene", "all", "--seeds", "0", "1", "--vmap-seeds", "--tensorboard"],
    ["train", "--seeds", "0", "1", "--vmap-seeds", "--profile"],
    ["eval", "--ckpt", "x.npz", "--scene", "all"],
    ["predict", "--ckpt", "x.npz", "--scene", "all"],
], ids=["one-seed", "resume", "stream", "tensorboard", "profile", "eval-all", "predict-all"])
def test_guards_print_the_jax_messages(argv, capsys):
    want = _error_line(j_cli.main, argv, capsys)
    assert _error_line(cli.main, argv, capsys) == want


# -- eval-loo -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A flat single-seed tree, a two-seed tree and a second two-seed tree of
    JAX-initialised checkpoints (one a fold and seed), on five small scenes."""
    root = tmp_path_factory.mktemp("loo")
    data = root / "data"
    data.mkdir()
    write_scenes(data)
    jm = JForecaster(JModelConfig(**SMALL), TO, TP)
    out = {}
    for tree, seeds in (("flat", [None]), ("two", [0, 1]), ("other", [0, 1])):
        for i, scene in enumerate(SCENES):
            for seed in seeds:
                sub = scene if seed is None else f"s{seed}/{scene}"
                d = root / tree / sub
                d.mkdir(parents=True)
                key = 100 * (tree == "other") + 10 * i + (seed or 0)
                cfg = JConfig(model=JModelConfig(**SMALL),
                              data=JDataConfig(data_dir=str(data), scene=scene, obs_len=TO,
                                               pred_len=TP, n_max=8),
                              train=JTrainConfig(k_samples=K, seed=seed or 0))
                stats = JNormStats(np.full(2, 0.05 * i, np.float32),
                                   np.full(2, 0.3 + 0.01 * i, np.float32))
                j_checkpoint.save_npz(str(d / "checkpoint.npz"), jm.init(jax.random.PRNGKey(key)),
                                      stats, cfg, step=3)
        out[tree] = str(root / tree)
    return jm, out


def _spy(module, name, seen):
    real = getattr(module, name)

    def spy(*args, **kw):
        m = real(*args, **kw)
        seen.append((m["min_ade"], m["min_fde"]))
        return m

    return spy


_NUM = re.compile(r"-?\d+\.\d+")


@pytest.mark.parametrize("trees_used, flags", [
    (["flat"], []),
    (["two"], ["--oversample", "2"]),
    (["two"], ["--ensemble"]),
    (["two", "other"], ["--ensemble"]),
], ids=["flat", "oversample", "ensemble", "two-trees"])
def test_eval_loo_matches_jax(trees_used, flags, trees, monkeypatch, capsys):
    jm, paths = trees
    argv = ["eval-loo", "--loo-dir", *(paths[t] for t in trees_used)] + flags
    j_seen, p_seen = [], []
    for name in ("evaluate", "evaluate_mixed"):
        monkeypatch.setattr(j_evaluate_mod, name, _spy(j_evaluate_mod, name, j_seen))
        monkeypatch.setattr(ev, name, _spy(ev, name, p_seen))
    assert j_cli.main(argv) == 0
    want = capsys.readouterr().out
    monkeypatch.setattr(ev, "window_stream", jax_window_stream(jm))
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    n_folds = 5 * (1 if "--ensemble" in flags else len(trees_used) * (1 + (trees_used != ["flat"])))
    assert len(p_seen) == len(j_seen) == n_folds
    np.testing.assert_allclose(np.array(p_seen), np.array(j_seen), rtol=0, atol=FOLD_TOL)
    assert _NUM.sub("#", got) == _NUM.sub("#", want)
    assert "leave-one-out eval (best-of-3" in got and "AVG" in got


@pytest.mark.parametrize("argv_of", [
    lambda p: ["eval-loo", "--loo-dir", p["two"], p["other"]],
    lambda p: ["eval-loo", "--loo-dir", p["two"], "--ensemble", "--rollout", "modes"],
    lambda p: ["eval-loo", "--loo-dir", p["two"], p["other"], "--ensemble", "--buckets", "4"],
    lambda p: ["eval-loo", "--loo-dir", p["flat"], "--seeds", "0"],
    lambda p: ["eval-loo", "--loo-dir", p["flat"], "--ensemble"],
], ids=["trees-without-ensemble", "ensemble-modes", "buckets-trees", "seeds-flat",
        "ensemble-one-member"])
def test_eval_loo_guards_print_the_jax_messages(argv_of, trees, capsys):
    argv = argv_of(trees[1])
    want = _error_line(j_cli.main, argv, capsys)
    assert _error_line(cli.main, argv + ["--device", "cpu"], capsys) == want
