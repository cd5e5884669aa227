"""One training step of the port against the JAX package's, on the CPU.

The same parameters (``from_jax``), the same batch and JAX's own draws:
``mmtraj_torch.train.step_draws`` is replaced by JAX's augment angles and
flips, dropout masks and variety stream for the step, folded from
``PRNGKey(seed ^ 0x5EED)`` as ``mmtraj/train.py`` folds them.  JAX's loss
and gradients both come out of ``mmtraj.train.make_train_step`` itself,
given an optimizer whose state keeps the gradients and whose update is zero.

Tolerances: the loss within 1e-5 relative, every gradient leaf within 1e-4
relative and 1e-6 absolute.  Both sides run float32 through the same 7 steps
of recurrence and the same NLL or min-over-samples, in another summation
order; the gradients see that rounding amplified by the backward pass.
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
from mmtraj_torch.ops import fused_attend, fused_gat
from mmtraj_torch.params import flatten, from_jax
from torch_jax_streams import SMALL, TO, TP, grad_keeper, jax_step_draws, random_windows

torch.set_num_threads(2)

B, N, SEED, STEP, VARIETY_N = 4, 8, 3, 5, 2
MEAN = np.array([0.02, -0.01], np.float32)
STD = np.array([0.3, 0.35], np.float32)
ROUTES = {"plain": dict(), "use_pallas": dict(use_pallas=True)}


def _batch():
    rng = np.random.default_rng(7)
    counts = [8, 5, 3, 6]
    xy = np.zeros((B, N, TO + TP, 2), np.float32)
    mask = np.zeros((B, N), bool)
    for b, w in enumerate(random_windows(rng, counts)):
        xy[b, :len(w)] = w + rng.normal(size=(1, 1, 2)).astype(np.float32) * 2
        mask[b, :len(w)] = True
    return xy, mask


def _configs(route, dropout):
    jmc = dataclasses.replace(jconfig.config4().model, **SMALL, remat=True, dropout=dropout,
                              **ROUTES[route])
    return jmc, config.ModelConfig(**dataclasses.asdict(jmc))


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("loss_mode", ["nll", "variety", "hybrid"])
def test_train_step_loss_and_gradients_match_jax(loss_mode, route, monkeypatch):
    """With dropout and augment (rotation and flip) on."""
    jmc, mc = _configs(route, dropout=0.2)
    jm = JForecaster(jmc, TO, TP)
    params = jm.init(jax.random.PRNGKey(1))
    state = from_jax(jax.tree.map(np.asarray, params))  # the step donates params
    xy, mask = _batch()
    kw = dict(augment_rotate=True, augment_flip=True, seed=SEED, loss_mode=loss_mode,
              variety_n=VARIETY_N, variety_weight=0.7, variety_fde_weight=0.5)
    keeper = grad_keeper()
    jstep = j_make_train_step(jm, keeper, JNormStats(MEAN, STD), **kw)
    _, jgrads, jloss = jstep(params, keeper.init(params), jnp.asarray(xy), jnp.asarray(mask),
                             jnp.int32(STEP))

    draws = jax_step_draws(jm)(None, SEED, STEP, B, N, True, True,
                               VARIETY_N if loss_mode != "nll" else 0)
    monkeypatch.setattr(train, "step_draws", lambda *a, **k: draws)
    model = Forecaster(mc, TO, TP, device="cpu", state=state)
    cfg = config.config4().replace(model=mc)
    step = train.make_train_step(model, train.make_optimizer(cfg, model), NormStats(MEAN, STD),
                                 **kw)
    loss = step(torch.from_numpy(xy), torch.from_numpy(mask), STEP)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = flatten(jax.tree.map(np.asarray, jgrads))
    got = {k: p.grad for k, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] is not None, k
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_step_draws_are_a_function_of_seed_and_step():
    mc = config.ModelConfig(**SMALL, dropout=0.3)
    model = Forecaster(mc, TO, TP, device="cpu", generator=torch.Generator().manual_seed(0))
    a = train.step_draws(model, 0, 4, B, N, True, True, 2)
    b = train.step_draws(model, 0, 4, B, N, True, True, 2)
    c = train.step_draws(model, 0, 5, B, N, True, True, 2)
    for x, y in ((a.theta, b.theta), (a.det, b.det), (a.stream[0], b.stream[0]),
                 (a.drop[0]["emb"], b.drop[0]["emb"])):
        assert torch.equal(x, y)
    assert not torch.equal(a.theta, c.theta)
    assert ((a.theta >= 0) & (a.theta < 2 * np.pi)).all()
    assert set(a.det.tolist()) <= {-1.0, 1.0}
    keep = 1 - mc.dropout
    assert set(a.drop[1]["gat"].unique().tolist()) <= {0.0, (torch.ones(()) / keep).item()}
    assert a.stream[0].shape == (2 * B, TP, N, mc.num_mixtures)
    none = train.step_draws(Forecaster(config.ModelConfig(**SMALL), TO, TP, device="cpu",
                                       generator=torch.Generator()), 0, 1, B, N, False, False, 0)
    assert none == train.StepDraws()


@pytest.mark.parametrize("loss_mode, per_coder_steps", [("nll", 1), ("variety", 1),
                                                         ("hybrid", 2)])
@pytest.mark.parametrize("kernel", ["fused_gat", "attend"])
def test_kernel_calls_a_training_step(kernel, loss_mode, per_coder_steps, monkeypatch):
    """Under remat "full" each GAT call of the forward runs again in the
    backward's recomputation: a step calls the kernel 2 (TO + TP) times for
    nll or variety, and twice that for hybrid (which encodes twice).  The
    card's launch counts (chip_smoke.py phase 10) follow this count."""
    route = dict(use_pallas=True) if kernel == "fused_gat" else dict(attend_kernel="pallas")
    mc = config.ModelConfig(**SMALL, remat=True, **route)
    model = Forecaster(mc, TO, TP, device="cpu", generator=torch.Generator().manual_seed(0))
    calls = []
    module, name = (fused_gat, "fused_gat") if kernel == "fused_gat" else (fused_attend, "attend")
    real = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = config.config4().replace(model=mc)
    step = train.make_train_step(model, train.make_optimizer(cfg, model), NormStats(MEAN, STD),
                                 loss_mode=loss_mode, variety_n=VARIETY_N)
    xy, mask = _batch()
    step(torch.from_numpy(xy), torch.from_numpy(mask), 0)
    assert len(calls) == 2 * (TO + TP) * per_coder_steps


@pytest.mark.parametrize("name", ["1", "2", "3", "4", "5"])
def test_presets_are_the_jax_presets(name):
    assert dataclasses.asdict(config.get_config(name)) == dataclasses.asdict(
        jconfig.get_config(name))
    assert config.get_config(f"config{name}") == config.get_config(name)
