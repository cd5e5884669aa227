"""Shared by the config-3 parity tests of the port (``test_torch_config3*.py``):
config 3 with RESULTS.md's recipe, in both packages, its windows and models."""

import dataclasses

import jax
import numpy as np

from mmtraj import config as jconfig
from mmtraj.models.forecaster import Forecaster as JForecaster
from mmtraj_torch import config
from mmtraj_torch.models.forecaster import Forecaster
from mmtraj_torch.params import from_jax

TO, TP, N = 8, 12, 32
SEED, STEP = 3, 7
MEAN, STD = np.array([0.02, -0.01], np.float32), np.array([0.35, 0.3], np.float32)
RECIPE_MODEL = dict(adjacency_radius=2.0, dropout=0.1)
RECIPE_TRAIN = dict(loss="variety", variety_n=8, augment_rotate=True, augment_flip=True,
                    weight_decay=1e-4, ema_decay=0.995, lr_schedule="cosine", steps=32000,
                    steps_per_dispatch=50)
ROUTES = {
    "plain": dict(),
    "A": dict(use_pallas=True, use_fused_decoder=True),
    "B": dict(attend_kernel="pallas"),
}
TRAJ = dict(atol=1e-4, rtol=1e-4)
GRAD = dict(rtol=1e-4, atol=1e-6)
LANE_TOL = dict(rtol=1e-5, atol=1e-6)
METRIC_TOL = 1e-6
PARAM_TOL = 1e-4


def recipe_jcfg(**model):
    """JAX's config 3 with the recipe's training fields and ``model`` changes."""
    c = jconfig.config3()
    return c.replace(model=dataclasses.replace(c.model, **model),
                     train=dataclasses.replace(c.train, **RECIPE_TRAIN))


def port_config(jcfg):
    return config.Config(
        model=config.ModelConfig(**dataclasses.asdict(jcfg.model)),
        data=config.DataConfig(**dataclasses.asdict(jcfg.data)),
        train=config.TrainConfig(**dataclasses.asdict(jcfg.train)))


def random_windows(b, seed=0, valid=0.6):
    """b windows of N agents, TO + TP frames: random walks started over
    about 3 m, so a 2 m radius keeps some edges and drops others; a share
    ``valid`` of the agents present, agent 0 always."""
    rng = np.random.default_rng(seed)
    steps = rng.normal(size=(b, N, TO + TP, 2)).astype(np.float32) * 0.3
    xy = (np.cumsum(steps, axis=2) + rng.normal(size=(b, N, 1, 2)) * 1.5).astype(np.float32)
    mask = rng.random((b, N)) < valid
    mask[:, 0] = True
    return xy, mask


def jax_model(jcfg, seed=0):
    jm = JForecaster(jcfg.model, TO, TP)
    return jm, jm.init(jax.random.PRNGKey(seed))


def port_model(mc, params):
    return Forecaster(config.ModelConfig(**dataclasses.asdict(mc)), TO, TP, device="cpu",
                      state=from_jax(jax.tree.map(np.asarray, params)))
