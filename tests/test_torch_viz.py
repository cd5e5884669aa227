"""Plots of the port (``mmtraj_torch/utils/viz.py``) and ``cli visualize``
against the JAX package's: PNGs byte-equal from the same arrays, and on a
tiny config fed JAX's stream the same windows and rollouts within 1e-4 m.

JAX's CLI reads scenes through ``mmtraj.data.registry``, whose native parser
races under several test workers, so its reader is pointed at JAX's numpy
parser here (as ``tests/test_torch_loo.py`` does)."""

import os

import jax
import numpy as np
import pytest
import torch

import mmtraj.data.registry as j_registry
import mmtraj.utils.viz as j_viz
import mmtraj_torch.cli as cli
import mmtraj_torch.utils.viz as viz
from mmtraj.cli import main as j_cli_main
from mmtraj.config import ModelConfig as JModelConfig
from mmtraj.data.parser import read_annotation_file as j_read_annotation_file
from mmtraj.models.forecaster import Forecaster as JForecaster
from mmtraj_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from mmtraj_torch.data.transforms import NormStats
from mmtraj_torch.params import from_jax, save_npz
from torch_jax_streams import TO, TP, write_scenes

torch.set_num_threads(2)

SMALL = dict(num_heads=2, embed_dim=8, hidden_dim=16, num_mixtures=2)
K, N_MAX, SCENE = 3, 8, "zara1"


def _arrays(rng, b, n=5):
    xy = np.cumsum(rng.normal(size=(b, n, TO + TP, 2)).astype(np.float32) * 0.3, axis=2)
    mask = np.zeros((b, n), bool)
    for w in range(b):
        mask[w, : 1 + w % n] = True
    rollouts = xy[None, :, :, TO:] + rng.normal(size=(K, b, n, TP, 2)).astype(np.float32) * 0.2
    return xy, mask, rollouts


@pytest.mark.parametrize("b, max_windows", [(4, 6), (7, 6), (1, 6)])
def test_render_predictions_writes_the_jax_png(tmp_path, b, max_windows):
    pytest.importorskip("matplotlib")
    xy, mask, rollouts = _arrays(np.random.default_rng(b), b)
    mine, theirs = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    assert viz.render_predictions(mine, xy, mask, rollouts, TO, max_windows) == mine
    j_viz.render_predictions(theirs, xy, mask, rollouts, TO, max_windows)
    assert os.path.getsize(mine) > 10_000  # a non-trivial image
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()


def test_colors_are_jax_colors():
    pytest.importorskip("matplotlib")
    assert viz._colors(23) == j_viz._colors(23)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(JAX model, checkpoint path of both packages) on a tiny config."""
    root = tmp_path_factory.mktemp("viz")
    data = write_scenes(root, frames=18)
    jm = JForecaster(JModelConfig(**SMALL), TO, TP)
    params = jm.init(jax.random.PRNGKey(0))
    cfg = Config(model=ModelConfig(**SMALL),
                 data=DataConfig(data_dir=data, scene=SCENE, obs_len=TO, pred_len=TP,
                                 n_max=N_MAX),
                 train=TrainConfig(k_samples=K))
    ckpt = str(root / "ckpt.npz")
    stats = NormStats(np.array([0.01, -0.02], np.float32), np.array([0.4, 0.5], np.float32))
    save_npz(ckpt, from_jax(jax.tree.map(np.asarray, params)), stats, cfg)
    return jm, ckpt


def _captured(module, monkeypatch):
    """Replace ``module.render_predictions`` by one that keeps its arguments."""
    got = {}

    def render(out_path, xy, mask, rollouts, obs_len, max_windows=6):
        got.update(xy=np.asarray(xy), mask=np.asarray(mask), rollouts=np.asarray(rollouts))
        return out_path

    monkeypatch.setattr(module, "render_predictions", render)
    return got


@pytest.mark.parametrize("windows, seed", [(4, 0), (3, 7)])
def test_cli_visualize_plots_jax_windows_and_rollouts(setup, tmp_path, monkeypatch, capsys,
                                                      windows, seed):
    jm, ckpt = setup
    monkeypatch.setattr(j_registry, "read_annotation_file", j_read_annotation_file)
    theirs = _captured(j_viz, monkeypatch)
    args = ["visualize", "--ckpt", ckpt, "--out", str(tmp_path / "p.png"),
            "--windows", str(windows), "--seed", str(seed)]
    assert j_cli_main(args) == 0
    j_line = capsys.readouterr().out

    # JAX's visualize draws rollout_k's stream from PRNGKey(seed): hand it over.
    b = theirs["xy"].shape[0]
    stream = tuple(torch.from_numpy(np.array(a))
                   for a in jm._rollout_stream(jax.random.PRNGKey(seed), K * b, N_MAX))
    real = cli.visualize_rollouts
    monkeypatch.setattr(cli, "visualize_rollouts",
                        lambda *a, **kw: real(*a, **kw, stream=stream))
    mine = _captured(viz, monkeypatch)
    assert cli.main([*args, "--device", "cpu"]) == 0
    assert capsys.readouterr().out == j_line
    assert b == windows and j_line.startswith(f"wrote {tmp_path / 'p.png'} ({windows} windows")
    np.testing.assert_array_equal(mine["xy"], theirs["xy"])  # the same windows, in order
    np.testing.assert_array_equal(mine["mask"], theirs["mask"])
    assert mine["rollouts"].shape == (K, b, N_MAX, TP, 2)
    m = mine["mask"][None, :, :, None, None]
    np.testing.assert_allclose(np.where(m, mine["rollouts"], 0),
                               np.where(m, theirs["rollouts"], 0), atol=1e-4, rtol=0)


def test_cli_visualize_writes_a_png(setup, tmp_path, capsys):
    pytest.importorskip("matplotlib")
    _, ckpt = setup
    out = tmp_path / "pred.png"
    assert cli.main(["visualize", "--ckpt", ckpt, "--out", str(out), "--windows", "2",
                     "--device", "cpu"]) == 0
    assert capsys.readouterr().out == f"wrote {out} (2 windows, K={K}, scene={SCENE})\n"
    assert out.stat().st_size > 10_000


def test_visualize_rollouts_draw_from_the_seed(setup):
    """Without a stream, a generator seeded with ``seed``: one seed repeats,
    another differs, in its windows and its rollouts."""
    from mmtraj_torch import checkpoint

    ck = checkpoint.load(setup[1])
    a, b, c = (cli.visualize_rollouts(ck, ck.config, 3, s, "cpu") for s in (5, 5, 6))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[2], c[2]) and not np.array_equal(a[0], c[0])
    assert np.isfinite(a[2]).all() and a[2].shape == (K, 3, N_MAX, TP, 2)
