"""The port's closed-form baselines (``mmtraj_torch/baselines.py``) and
``cli baseline``, on the CPU: every case of ``tests/test_baselines.py`` on
the port, ``evaluate_baseline`` equal to the JAX package's with ``==``, and
``cli baseline --scene all`` printing the JAX CLI's lines byte for byte.
JAX's CLI reads scenes through ``mmtraj.data.registry``, whose native
parser races under ``pytest -n``; these tests point it at the numpy parser."""

import numpy as np
import pytest

import mmtraj.data.registry as j_registry
from mmtraj import baselines as j_baselines
from mmtraj import cli as j_cli
from mmtraj.data.collate import WindowDataset as JWindowDataset
from mmtraj.data.parser import read_annotation_file as j_read_annotation_file
from mmtraj_torch import cli
from mmtraj_torch.baselines import constant_velocity, evaluate_baseline, zero_velocity
from mmtraj_torch.config import SCENES
from mmtraj_torch.data.collate import WindowDataset
from mmtraj_torch.data.registry import load_scene_windows
from mmtraj_torch.data.synthetic import write_synthetic_dataset

OBS, PRED = 8, 12


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    write_synthetic_dataset(str(d), seed=0, n_frames=120)
    return str(d)


def test_cv_exact_on_linear_motion():
    t = np.arange(OBS + PRED, dtype=np.float32)
    v = np.array([[0.5, -0.2], [0.0, 1.0]], np.float32)
    xy = v[:, None, :] * t[None, :, None] + np.float32(3.0)
    m = evaluate_baseline(WindowDataset([xy], n_max=4), OBS, "cv")
    assert m["min_ade"] < 1e-5 and m["min_fde"] < 1e-5
    assert m["k"] == 1 and m["baseline"] == "cv"


def test_zv_freezes_last_position():
    rng = np.random.default_rng(0)
    obs = np.cumsum(rng.normal(size=(3, OBS, 2)), axis=1).astype(np.float32)
    pred = zero_velocity(obs, PRED)
    assert pred.shape == (3, PRED, 2)
    np.testing.assert_array_equal(pred, np.broadcast_to(obs[:, -1:], pred.shape))


def test_cv_extrapolates_last_offset():
    obs = np.zeros((1, OBS, 2), np.float32)
    obs[0, -1] = [1.0, 2.0]
    pred = constant_velocity(obs, 3)
    np.testing.assert_allclose(pred[0], [[2, 4], [3, 6], [4, 8]])


def test_evaluate_baseline_masks_padding():
    t = np.arange(OBS + PRED, dtype=np.float32)
    xy = np.stack([t, t], axis=-1)[None]
    small = evaluate_baseline(WindowDataset([xy], n_max=1), OBS, "cv")
    padded = evaluate_baseline(WindowDataset([xy], n_max=16), OBS, "cv")
    assert small["min_ade"] == padded["min_ade"]
    assert padded["n_agents"] == 1


def test_unknown_baseline_raises():
    ds = WindowDataset([np.zeros((1, OBS + PRED, 2), np.float32)], 2)
    with pytest.raises(ValueError, match="unknown baseline"):
        evaluate_baseline(ds, OBS, "oracle")


@pytest.mark.parametrize("baseline", ["cv", "zv"])
def test_evaluate_baseline_equals_jax(baseline, synth):
    rng = np.random.default_rng(1)
    obs = np.cumsum(rng.normal(size=(5, 3, OBS, 2)), axis=2).astype(np.float32)
    np.testing.assert_array_equal(
        {"cv": constant_velocity, "zv": zero_velocity}[baseline](obs, PRED),
        {"cv": j_baselines.constant_velocity, "zv": j_baselines.zero_velocity}[baseline](
            obs, PRED))
    for scene in SCENES:
        windows = load_scene_windows(synth, scene, OBS, PRED)
        n_max = max(w.shape[0] for w in windows)
        got = evaluate_baseline(WindowDataset(windows, n_max), OBS, baseline)
        want = j_baselines.evaluate_baseline(JWindowDataset(windows, n_max), OBS, baseline)
        assert got == want and got["n_agents"] > 0


@pytest.mark.parametrize("baseline", ["cv", "zv"])
def test_cli_baseline_scene_all_prints_the_jax_lines(baseline, synth, monkeypatch, capsys):
    monkeypatch.setenv("MMTRAJ_COMPILE_CACHE", "off")
    monkeypatch.setattr(j_registry, "read_annotation_file", j_read_annotation_file)
    argv = ["baseline", "--data-dir", synth, "--scene", "all", "--baseline", baseline]
    assert j_cli.main(argv) == 0
    want = capsys.readouterr().out
    assert cli.main(argv) == 0
    got = capsys.readouterr().out
    assert got == want and got.count("\n") == len(SCENES) + 1 and baseline.upper() in got


def test_cli_baseline_runs(synth, capsys):
    assert cli.main(["baseline", "--data-dir", synth, "--scene", "zara1", "--baseline", "cv"]) == 0
    out = capsys.readouterr().out
    assert "CV" in out and "ADE=" in out
