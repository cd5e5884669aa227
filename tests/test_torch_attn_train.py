"""Training the attention encoder (``encoder="attn"``) in the port, against
the JAX package on the CPU.

A step of each loss (nll, variety, hybrid) with dropout masks and augment,
on the plain route and under ``use_pallas``: the same parameters
(``from_jax``), the same batch and JAX's draws through ``step_draws``; JAX's
loss and gradients come out of its own ``make_train_step``.  The loss within
1e-5 relative, every gradient leaf within 1e-4 relative and 1e-6 absolute,
as for the rnn encoder in ``test_torch_train_step.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtraj import config as jconfig
from mmtraj.data.transforms import NormStats as JNormStats
from mmtraj.models.forecaster import Forecaster as JForecaster
from mmtraj.train import make_train_step as j_make_train_step
from mmtraj_torch import config, train
from mmtraj_torch.data.transforms import NormStats
from mmtraj_torch.models.forecaster import Forecaster
from mmtraj_torch.ops import fused_gat
from mmtraj_torch.params import flatten, from_jax, load_npz
from torch_jax_streams import (SMALL, TO, TP, grad_keeper, jax_step_draws, random_windows,
                               write_scenes)

torch.set_num_threads(2)

B, N, SEED, STEP, VARIETY_N = 3, 8, 4, 2, 2
MEAN = np.array([0.01, 0.02], np.float32)
STD = np.array([0.35, 0.3], np.float32)
ROUTES = {"plain": dict(), "use_pallas": dict(use_pallas=True)}


def _batch():
    rng = np.random.default_rng(3)
    xy = np.zeros((B, N, TO + TP, 2), np.float32)
    mask = np.zeros((B, N), bool)
    for b, w in enumerate(random_windows(rng, [8, 4, 6])):
        xy[b, :len(w)] = w + rng.normal(size=(1, 1, 2)).astype(np.float32) * 2
        mask[b, :len(w)] = True
    return xy, mask


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("loss_mode", ["nll", "variety", "hybrid"])
def test_attn_train_step_matches_jax(loss_mode, route, monkeypatch):
    jmc = dataclasses.replace(jconfig.config4().model, **SMALL, encoder="attn", remat=True,
                              dropout=0.2, **ROUTES[route])
    jm = JForecaster(jmc, TO, TP)
    params = jm.init(jax.random.PRNGKey(5))
    state = from_jax(jax.tree.map(np.asarray, params))  # the step donates params
    xy, mask = _batch()
    kw = dict(augment_rotate=True, augment_flip=True, seed=SEED, loss_mode=loss_mode,
              variety_n=VARIETY_N, variety_weight=0.7)
    keeper = grad_keeper()
    jstep = j_make_train_step(jm, keeper, JNormStats(MEAN, STD), **kw)
    _, jgrads, jloss = jstep(params, keeper.init(params), jnp.asarray(xy), jnp.asarray(mask),
                             jnp.int32(STEP))

    monkeypatch.setattr(train, "step_draws", jax_step_draws(jm))
    mc = config.ModelConfig(**dataclasses.asdict(jmc))
    model = Forecaster(mc, TO, TP, device="cpu", state=state)
    step = train.make_train_step(model, train.make_optimizer(config.config4().replace(model=mc),
                                                             model),
                                 NormStats(MEAN, STD), **kw)
    loss = step(torch.from_numpy(xy), torch.from_numpy(mask), STEP)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = flatten(jax.tree.map(np.asarray, jgrads))
    got = {k: p.grad for k, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("loss_mode, encodes", [("nll", 1), ("variety", 1), ("hybrid", 2)])
def test_fused_gat_calls_an_attn_training_step(loss_mode, encodes, monkeypatch):
    """Under ``use_pallas`` and remat "full": each of the encoder's layers
    calls the GAT once over its B*T graphs, each decoder step once, and the
    recomputation calls them all again; hybrid encodes and decodes twice.
    The card's launch counts (``chip_smoke.py`` phase 11) follow this."""
    mc = config.ModelConfig(**SMALL, encoder="attn", remat=True, use_pallas=True)
    model = Forecaster(mc, TO, TP, device="cpu", generator=torch.Generator().manual_seed(0))
    calls = []
    real = fused_gat.fused_gat
    monkeypatch.setattr(fused_gat, "fused_gat", lambda *a, **k: calls.append(a[0].shape[0])
                        or real(*a, **k))
    step = train.make_train_step(model, train.make_optimizer(config.config4().replace(model=mc),
                                                             model),
                                 NormStats(MEAN, STD), loss_mode=loss_mode, variety_n=VARIETY_N)
    xy, mask = _batch()
    step(torch.from_numpy(xy), torch.from_numpy(mask), 0)
    assert len(calls) == 2 * (mc.attn_layers + TP) * encodes
    assert calls.count(B * TO) == 2 * mc.attn_layers * encodes


def test_fit_trains_the_attn_encoder(tmp_path):
    """A short ``fit`` (dropout, EMA, chunks of 2) writes a checkpoint whose
    parameters moved and whose final eval is finite."""
    (tmp_path / "scenes").mkdir()
    data_dir = write_scenes(tmp_path / "scenes")
    cfg = config.config4()
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, **SMALL, encoder="attn", dropout=0.1),
        data=dataclasses.replace(cfg.data, data_dir=data_dir, n_max=8, obs_len=TO, pred_len=TP),
        train=dataclasses.replace(cfg.train, steps=5, batch_size=4, eval_every=0, log_every=1,
                                  k_samples=2, ema_decay=0.9, steps_per_dispatch=2,
                                  out_dir=str(tmp_path / "run")))
    result = train.fit(cfg, device="cpu")
    assert [s for s, _ in result.history] == [1, 2, 3, 4, 5]
    assert all(np.isfinite(lv) for _, lv in result.history)
    assert all(np.isfinite(result.eval_metrics[k]) for k in ("min_ade", "min_fde", "nll"))
    ck = load_npz(str(tmp_path / "run" / "checkpoint.npz"))
    assert ck.step == 5 and ck.config.model.encoder == "attn"
    start = Forecaster(cfg.model, TO, TP, device="cpu",
                       generator=torch.Generator().manual_seed(cfg.train.seed)).state_dict()
    assert any(not torch.equal(start[k], ck.state[k]) for k in start)
