"""The port's optimizer, data order and checkpoints against the JAX package's.

The optimizer is held to optax on its own: fed the same gradients (numpy,
from a seed) from the same parameters, the port's clip + AdamW + schedule
gives optax's parameters within 1e-7 over several steps, the cosine warm-up
included (both sides run float32; only the rounding of the bias
corrections and the learning rate may differ, about 1e-7 relative of an
update of about lr).  Comparing parameters after one step from gradients
computed apart would prove nothing: Adam's first step is about
lr * sign(g), so a gradient near 0 whose sign differs moves a parameter by
2 lr.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtraj import checkpoint as jckpt
from mmtraj import config as jconfig
from mmtraj.data.collate import WindowDataset as JWindowDataset
from mmtraj.data.pipeline import DeviceDataset as JDeviceDataset
from mmtraj.data.transforms import NormStats as JNormStats
from mmtraj.models.forecaster import init_params as j_init_params
from mmtraj.train import make_optimizer as j_make_optimizer
from mmtraj_torch import config, train
from mmtraj_torch.data.collate import WindowDataset
from mmtraj_torch.data.pipeline import DeviceDataset
from mmtraj_torch.data.transforms import NormStats
from mmtraj_torch.models.forecaster import Forecaster
from mmtraj_torch.params import flatten, from_jax, load_npz, save_npz, unflatten
from torch_jax_streams import SMALL, random_windows

torch.set_num_threads(2)

OPT_CASES = {
    "constant": dict(lr_schedule="constant"),
    "cosine": dict(lr_schedule="cosine", warmup_steps=2, steps=6),
    "cosine, weight decay": dict(lr_schedule="cosine", warmup_steps=2, steps=6,
                                 weight_decay=0.01),
    "constant, no clip": dict(lr_schedule="constant", grad_clip=0.0, lr=3e-3),
}


def _setup(change):
    jcfg = jconfig.config4()
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, **SMALL),
                        train=dataclasses.replace(jcfg.train, **change))
    cfg = config.config4()
    cfg = cfg.replace(model=config.ModelConfig(**dataclasses.asdict(jcfg.model)),
                      train=config.TrainConfig(**dataclasses.asdict(jcfg.train)))
    params = j_init_params(jax.random.PRNGKey(0), jcfg.model)
    model = Forecaster(cfg.model, 4, 3, device="cpu",
                       state=from_jax(jax.tree.map(np.asarray, params)))
    return jcfg, cfg, params, model


def _grads(rng, params, scale):
    return jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32) * scale),
                        params)


def _port_grads(opt, jgrads):
    flat = flatten(jax.tree.map(np.asarray, jgrads))
    return [torch.from_numpy(np.array(flat[k])) for k in opt.names]


def _assert_params(model, jparams, atol=1e-7):
    want = flatten(jax.tree.map(np.asarray, jparams))
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_matches_optax(case):
    """Six steps; the global norm is above the clip in all but the step of
    small gradients; under "cosine" the first update runs at lr 0."""
    jcfg, cfg, params, model = _setup(OPT_CASES[case])
    tx = j_make_optimizer(jcfg)
    state = tx.init(params)
    opt = train.make_optimizer(cfg, model)
    rng = np.random.default_rng(1)
    for i, scale in enumerate((0.5, 0.05, 1e-4, 0.3, 2.0, 0.01)):
        g = _grads(rng, params, scale)
        updates, state = tx.update(g, state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        opt.step(_port_grads(opt, g))
        _assert_params(model, params)
    leaves = jax.tree.leaves(state)
    ours = opt.state_leaves()
    assert len(ours) == len(leaves)
    for a, b in zip(ours, leaves):  # moments within 1e-5 of each leaf's largest
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())
    if OPT_CASES[case]["lr_schedule"] == "cosine":
        assert train.lr_schedule(cfg)(0) == 0.0


def test_a_jax_checkpoint_with_optimizer_state_resumes_in_the_port(tmp_path):
    """JAX trains two steps and saves with ``opt_state``; the port loads the
    npz, and its next update from it equals optax's."""
    jcfg, cfg, params, _ = _setup(OPT_CASES["cosine"])
    tx = j_make_optimizer(jcfg)
    state = tx.init(params)
    rng = np.random.default_rng(2)
    for scale in (0.5, 0.02):
        updates, state = tx.update(_grads(rng, params, scale), state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
    stats = JNormStats(np.array([0.1, 0.0], np.float32), np.array([0.4, 0.5], np.float32))
    path = str(tmp_path / "jax.npz")
    jckpt.save_npz(path, params, stats, jcfg, 2, opt_state=state)

    ck = load_npz(path)
    assert ck.step == 2 and len(ck.opt_leaves) == len(jax.tree.leaves(state))
    model = Forecaster(ck.config.model, 4, 3, device="cpu", state=ck.state)
    _assert_params(model, params, atol=0)
    opt = train.make_optimizer(ck.config, model)
    opt.load_state_leaves(ck.opt_leaves)
    assert (opt.count, opt.schedule_count) == (2, 2)
    g = _grads(rng, params, 0.3)
    updates, state = tx.update(g, state, params)
    params = jax.tree.map(lambda p, u: p + u, params, updates)
    opt.step(_port_grads(opt, g))
    _assert_params(model, params)


def test_the_ports_checkpoint_round_trips_and_jax_reads_it(tmp_path):
    _, cfg, _, model = _setup(OPT_CASES["cosine"])
    opt = train.make_optimizer(cfg, model)
    rng = np.random.default_rng(3)
    for _ in range(2):
        opt.step([torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))
                  for p in opt.params])
    stats = NormStats(np.array([0.1, 0.2], np.float32), np.array([0.3, 0.4], np.float32))
    path = str(tmp_path / "port.npz")
    save_npz(path, model.state_dict(), stats, cfg, 2, opt.state_leaves())
    ck = load_npz(path)
    assert ck.step == 2 and dataclasses.asdict(ck.config) == dataclasses.asdict(cfg)
    for k, v in model.state_dict().items():
        assert torch.equal(ck.state[k], v), k
    again = train.make_optimizer(cfg, Forecaster(cfg.model, 4, 3, device="cpu", state=ck.state))
    again.load_state_leaves(ck.opt_leaves)
    for a, b in zip(again.state_leaves(), opt.state_leaves()):
        np.testing.assert_array_equal(a, b)
    # The JAX package reads it, and its optax state takes the leaves.
    jck = jckpt.load_npz(path)
    jstate = j_make_optimizer(jck.config).init(jck.params)
    assert [np.shape(x) for x in jax.tree.leaves(jstate)] == [a.shape for a in jck.opt_leaves]
    jax.tree.unflatten(jax.tree.structure(jstate), jck.opt_leaves)
    assert unflatten(dict(model.state_dict())).keys() == jck.params.keys()
    with pytest.raises(ValueError, match="leaves"):
        again.load_state_leaves(ck.opt_leaves[:-1])


@pytest.mark.parametrize("n_windows, batch", [(10, 4), (10, 5), (3, 8)])
def test_epoch_indices_equal_jax(n_windows, batch):
    """The same permutation and cyclic pad (batch > windows included)."""
    windows = random_windows(np.random.default_rng(0), [2] * n_windows)
    ours = DeviceDataset(WindowDataset(windows, 4), "cpu")
    theirs = JDeviceDataset(JWindowDataset(windows, 4))
    for epoch in (0, 3):
        a = list(ours.epoch_indices(batch, np.random.default_rng([5, epoch])))
        b = list(theirs.epoch_indices(batch, np.random.default_rng([5, epoch])))
        assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
        assert all(len(x) == batch for x in a)
    xy, mask = ours.batch(a[0])
    np.testing.assert_array_equal(xy.numpy(), ours.xy.numpy()[a[0]])
    assert mask.dtype == torch.bool
