"""The LSTM cell and the imported GRU parameters of the port, against the JAX
package on the CPU.

``cell_apply`` for the LSTM, the GRU with a recurrent bias ``bh`` and the
reset-before GRU (``wh_n``) within 1e-6 (a few float32 operations over one
product of width 16).  Config 1 (LSTM, no social graph, deterministic head)
from JAX's parameters: the encoder's bridged carry, the rollout, the loss and
every gradient leaf (loss within 1e-5 relative, gradients 1e-4 relative and
1e-6 absolute, as in ``test_torch_train_step.py``).  An LSTM with the social
GAT and the GMM head: rollouts on one JAX-drawn stream within 1e-4 m, on the
plain route and under ``use_pallas``.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from mmtraj import config as jconfig
from mmtraj.data.transforms import NormStats as JNormStats
from mmtraj.models.cells import Carry as JCarry
from mmtraj.models.cells import cell_apply as j_cell_apply
from mmtraj.models.forecaster import Forecaster as JForecaster
from mmtraj_torch import cli, config
from mmtraj_torch.data.transforms import NormStats
from mmtraj_torch.models.cells import Carry, cell_apply, cell_init
from mmtraj_torch.models.forecaster import Forecaster
from mmtraj_torch.params import flatten, from_jax, load_npz
from torch_jax_streams import SMALL, TO, TP, random_windows, write_scenes

torch.set_num_threads(2)

B, N, K = 3, 6, 4
MEAN = np.array([0.02, 0.01], np.float32)
STD = np.array([0.3, 0.4], np.float32)
CELL_TOL = dict(rtol=1e-6, atol=1e-6)


def _f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _cell_params(kind, rng, din=5, h=16):
    g = 4 if kind == "lstm" else 3
    p = {"wx": _f32(rng, din, g * h, scale=0.3), "wh": _f32(rng, h, g * h, scale=0.3),
         "b": _f32(rng, g * h, scale=0.1)}
    if kind == "gru+bh":
        p["bh"] = _f32(rng, 3 * h, scale=0.1)
    if kind == "gru+wh_n":
        p["wh"] = p["wh"][:, :2 * h]
        p["wh_n"] = _f32(rng, h, h, scale=0.3)
    return p


@pytest.mark.parametrize("kind", ["lstm", "gru+bh", "gru+wh_n"])
def test_cell_apply_matches_jax(kind):
    rng = np.random.default_rng(1)
    p = _cell_params(kind, rng)
    x, h, c = _f32(rng, 4, 7, 5), _f32(rng, 4, 7, 16, scale=0.5), _f32(rng, 4, 7, 16, scale=0.5)
    cell = kind.split("+")[0]
    want = j_cell_apply(p, cell, x, JCarry(h=h, c=c))
    got = cell_apply({k: torch.from_numpy(v) for k, v in p.items()}, cell, torch.from_numpy(x),
                     Carry(torch.from_numpy(h), torch.from_numpy(c)))
    np.testing.assert_allclose(got.h.numpy(), np.asarray(want.h), **CELL_TOL)
    np.testing.assert_allclose(got.c.numpy(), np.asarray(want.c), **CELL_TOL)


def test_lstm_cell_init_has_four_gates():
    p = cell_init(torch.Generator().manual_seed(0), "lstm", 5, 16)
    assert p["wx"].shape == (5, 64) and p["wh"].shape == (16, 64) and p["b"].shape == (64,)
    with pytest.raises(ValueError, match="cell"):
        cell_init(torch.Generator(), "rnn", 5, 16)


def _windows(seed=0):
    rng = np.random.default_rng(seed)
    xy = np.zeros((B, N, TO + TP, 2), np.float32)
    mask = np.zeros((B, N), bool)
    for b, w in enumerate(random_windows(rng, [6, 2, 4])):
        xy[b, :len(w)] = w + rng.normal(size=(1, 1, 2)).astype(np.float32) * 2
        mask[b, :len(w)] = True
    return xy, mask


def _models(preset, **change):
    jmc = dataclasses.replace(jconfig.get_config(preset).model, **SMALL, **change)
    jm = JForecaster(jmc, TO, TP)
    params = jm.init(jax.random.PRNGKey(7))
    model = Forecaster(config.ModelConfig(**dataclasses.asdict(jmc)), TO, TP, device="cpu",
                       state=from_jax(jax.tree.map(np.asarray, params)))
    return jm, params, model


def test_config1_matches_jax():
    """Encode (the carry, c through ``bridge_c``), rollout, loss, gradients."""
    jm, params, model = _models("1")
    assert model.cfg.cell == "lstm" and not model.cfg.social and model.cfg.head == "deterministic"
    assert "bridge_c.w" in model.state_dict()
    xy, mask = _windows()
    jstats, stats = JNormStats(MEAN, STD), NormStats(MEAN, STD)
    want = jm.encode(params, xy[:, :, :TO], mask, jstats)
    with torch.no_grad():
        got = model.encode(torch.from_numpy(xy[:, :, :TO]), torch.from_numpy(mask), stats)
    np.testing.assert_allclose(got.h.numpy(), np.asarray(want.h), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.c.numpy(), np.asarray(want.c), rtol=1e-5, atol=1e-6)
    roll = model.rollout_k(xy[:, :, :TO], mask, stats, 2)
    jroll = jm.rollout_k(params, xy[:, :, :TO], mask, jstats, jax.random.PRNGKey(0), 2)
    np.testing.assert_allclose(roll.numpy(), np.asarray(jroll), rtol=0, atol=1e-4)
    jloss, jgrads = jax.value_and_grad(lambda p: jm.loss(p, xy, mask, jstats)[0])(params)
    loss = model.loss(torch.from_numpy(xy), torch.from_numpy(mask), stats)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = flatten(jax.tree.map(np.asarray, jgrads))
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k], rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("route", [dict(), dict(use_pallas=True)])
@pytest.mark.parametrize("encoder", ["rnn", "attn"])
def test_lstm_with_the_social_gat_rolls_out_as_jax(route, encoder):
    jm, params, model = _models("4", cell="lstm", encoder=encoder, **route)
    xy, mask = _windows(1)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jm.rollout_k(params, xy[:, :, :TO], mask, JNormStats(MEAN, STD), key, K))
    stream = tuple(torch.from_numpy(np.array(a)) for a in jm._rollout_stream(key, K * B, N))
    got = model.rollout_k(xy[:, :, :TO], mask, NormStats(MEAN, STD), K, stream=stream)
    valid = np.broadcast_to(mask[None, :, :, None, None], want.shape)
    np.testing.assert_allclose(got.numpy()[valid], want[valid], rtol=0, atol=1e-4)


def test_the_fused_decoder_refuses_an_lstm():
    _, _, model = _models("4", cell="lstm", use_pallas=True, use_fused_decoder=True)
    xy, mask = _windows()
    with pytest.raises(AssertionError, match="GRU"):
        model.rollout_k(xy[:, :, :TO], mask, NormStats(MEAN, STD), 2)


def test_cli_train_config1_then_eval(tmp_path, capsys):
    (tmp_path / "scenes").mkdir()
    data_dir = write_scenes(tmp_path / "scenes")
    out = str(tmp_path / "run")
    code = cli.main(["train", "--config", "1", "--data-dir", data_dir, "--scene", "univ",
                     "--n-max", "8", "--obs-len", str(TO), "--pred-len", str(TP),
                     "--hidden-dim", "16", "--steps", "4", "--batch-size", "4",
                     "--steps-per-dispatch", "2", "--out-dir", out, "--device", "cpu"])
    assert code == 0
    assert "final: best-of-1" in capsys.readouterr().out
    ck = load_npz(os.path.join(out, "checkpoint.npz"))
    assert ck.step == 4 and ck.config.model.cell == "lstm" and ck.config.train.steps_per_dispatch == 2
    assert "bridge_c.w" in ck.state
    code = cli.main(["eval", "--ckpt", os.path.join(out, "checkpoint.npz"), "--device", "cpu"])
    assert code == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("scene=univ step=4 ") and "best-of-1 (per_agent)" in line
