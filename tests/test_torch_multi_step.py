"""Chunked training (``steps_per_dispatch``) and the device optimizer of the
port, on the CPU, against the per-step run and the JAX package.

On the CPU a chunk runs its steps eagerly through the same one-step core as
``make_train_step`` (on the card it replays a CUDA graph of that core), so
the chunked run follows the per-step one.  The tolerances are the JAX
package's own for its chunked program (``tests/test_train.py``): losses
rtol 1e-4 / atol 1e-5, parameters rtol 2e-3 / atol 2e-5.  Against JAX the
data are the port's random-walk scenes, handed to both packages as the same
numpy windows, and JAX's draws reach the port through ``step_draws``.
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from mmtraj import config as jconfig
from mmtraj import train as jtrain
from mmtraj.models.forecaster import Forecaster as JForecaster
from mmtraj.train import make_optimizer as j_make_optimizer
from mmtraj_torch import config, train
from mmtraj_torch.data.registry import load_split
from mmtraj_torch.models import forecaster as torch_forecaster
from mmtraj_torch.models.forecaster import Forecaster
from mmtraj_torch.params import flatten, from_jax, load_npz
from torch_jax_streams import SMALL, TO, TP, jax_step_draws, write_scenes

torch.set_num_threads(2)

LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=2e-3, atol=2e-5)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return write_scenes(tmp_path_factory.mktemp("scenes"))


def _cfg(preset, data_dir, out_dir, n_max=12, model_kw=None, **train_kw):
    cfg = config.get_config(preset)
    return cfg.replace(
        model=dataclasses.replace(cfg.model, **SMALL, **(model_kw or {})),
        data=dataclasses.replace(cfg.data, data_dir=data_dir, n_max=n_max, obs_len=TO,
                                 pred_len=TP),
        train=dataclasses.replace(cfg.train, **{
            "batch_size": 8, "eval_every": 0, "log_every": 5, "k_samples": 3,
            "out_dir": out_dir, **train_kw}))


def _variety_cfg(data_dir, out_dir, spd, steps=23):
    """JAX's ``test_multi_step_dispatch_matches_per_step`` run: dropout,
    variety n = 2, rotate and flip, EMA 0.99."""
    return _cfg("3", data_dir, out_dir, model_kw=dict(dropout=0.1), steps=steps,
                loss="variety", variety_n=2, augment_rotate=True, augment_flip=True,
                ema_decay=0.99, steps_per_dispatch=spd)


def _assert_runs_close(a, b):
    assert [s for s, _ in a.history] == [s for s, _ in b.history]
    for (s, x), (_, y) in zip(a.history, b.history):
        np.testing.assert_allclose(x, y, **LOSS_TOL, err_msg=f"loss at step {s}")
    assert sorted(a.state) == sorted(b.state)
    for k in a.state:
        np.testing.assert_allclose(np.asarray(a.state[k]), np.asarray(b.state[k]), **PARAM_TOL,
                                   err_msg=k)


def test_multi_step_dispatch_matches_per_step(data_dir, tmp_path):
    """23 = 3 * 7 + 2 steps: three chunks, then a ragged tail of two."""
    per_step = train.fit(_variety_cfg(data_dir, str(tmp_path / "spd1"), 1), device="cpu")
    chunked = train.fit(_variety_cfg(data_dir, str(tmp_path / "spd7"), 7), device="cpu")
    assert [s for s, _ in chunked.history] == [1, 5, 10, 15, 20]
    _assert_runs_close(per_step, chunked)


def test_multi_step_dispatch_boundaries_and_resume(data_dir, tmp_path):
    """M = 4 against ``ckpt_every`` 10: chunks of 4, 4 and a ragged 2 a
    period; the checkpoint lands at step 10, and the run cut there and
    resumed equals the uninterrupted one."""

    def run(out, steps, resume=False):
        cfg = _cfg("2", data_dir, str(tmp_path / out), n_max=16, steps=steps, ckpt_every=10,
                   steps_per_dispatch=4)
        return train.fit(cfg, resume=resume, device="cpu")

    whole = run("whole", 20)
    run("cut", 10)
    assert load_npz(str(tmp_path / "cut" / "checkpoint.npz")).step == 10
    resumed = run("cut", 20, resume=True)
    for k in whole.state:
        assert torch.equal(whole.state[k], resumed.state[k]), k
    a, b = (load_npz(str(tmp_path / d / "checkpoint.npz")) for d in ("whole", "cut"))
    assert a.step == b.step == 20
    for x, y in zip(a.opt_leaves, b.opt_leaves):
        np.testing.assert_array_equal(x, y)


def test_multi_step_dispatch_rejects_stream(data_dir, tmp_path):
    cfg = _cfg("1", data_dir, str(tmp_path), steps=4, stream=True, steps_per_dispatch=4)
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        train.fit(cfg, device="cpu")


def test_chunked_fit_matches_the_jax_packages(data_dir, tmp_path, monkeypatch):
    """Both packages start from JAX's initial parameters, train on the same
    windows with JAX's draws, 10 steps at M = 4 (two chunks and a ragged
    tail of two), and log the same losses and end at the same EMA
    parameters."""
    cfg = _variety_cfg(data_dir, str(tmp_path / "port"), 4, steps=10)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, log_every=1))
    windows = load_split(data_dir, cfg.data.scene, TO, TP, cfg.data.stride, cfg.data.min_agents)[0]
    jcfg = jconfig.Config(
        model=jconfig.ModelConfig(**dataclasses.asdict(cfg.model)),
        data=jconfig.DataConfig(**dataclasses.asdict(cfg.data)),
        train=jconfig.TrainConfig(**{**dataclasses.asdict(cfg.train),
                                     "out_dir": str(tmp_path / "jax")}))
    jm = JForecaster(jcfg.model, TO, TP)
    state = from_jax(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(cfg.train.seed))))

    monkeypatch.setattr(jtrain, "load_split", lambda *a, **k: (windows, []))
    want = jtrain.fit(jcfg)
    monkeypatch.setattr(train, "load_split", lambda *a, **k: (windows, []))
    monkeypatch.setattr(torch_forecaster, "init_params", lambda *a, **k: state)
    monkeypatch.setattr(train, "step_draws", jax_step_draws(jm))
    got = train.fit(cfg, device="cpu")

    assert [s for s, _ in got.history] == [s for s, _ in want.history] == list(range(1, 11))
    for (s, x), (_, y) in zip(got.history, want.history):
        np.testing.assert_allclose(x, y, **LOSS_TOL, err_msg=f"loss at step {s}")
    jparams = flatten(jax.tree.map(np.asarray, want.params))
    assert sorted(got.state) == sorted(jparams)
    for k, v in got.state.items():
        np.testing.assert_allclose(v.numpy(), jparams[k], **PARAM_TOL, err_msg=k)


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_device_optimizer_matches_optax_over_ten_updates(schedule):
    """The counts are int32 tensors on the parameters' device and the
    learning rate and bias corrections are computed there; ten updates
    (under "cosine" a warm-up of 3 of 12 steps) give optax's parameters
    within 1e-7 and its state leaves, the counts exactly."""
    change = dict(lr_schedule=schedule, warmup_steps=3, steps=12, weight_decay=0.01)
    jcfg = jconfig.config4()
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, **SMALL),
                        train=dataclasses.replace(jcfg.train, **change))
    cfg = config.config4().replace(model=config.ModelConfig(**dataclasses.asdict(jcfg.model)),
                                   train=config.TrainConfig(**dataclasses.asdict(jcfg.train)))
    params = jax.tree.map(np.asarray, JForecaster(jcfg.model, TO, TP).init(jax.random.PRNGKey(0)))
    model = Forecaster(cfg.model, TO, TP, device="cpu", state=from_jax(params))
    opt = train.make_optimizer(cfg, model)
    tx = j_make_optimizer(jcfg)
    jstate = tx.init(params)
    rng = np.random.default_rng(5)
    for i in range(10):
        scale = (0.5, 0.02, 1e-4, 3.0, 0.1)[i % 5]
        g = jax.tree.map(lambda p: (rng.normal(size=p.shape) * scale).astype(np.float32), params)
        updates, jstate = tx.update(g, jstate, params)
        params = optax.apply_updates(params, updates)
        flat = flatten(jax.tree.map(np.asarray, g))
        opt.step([torch.from_numpy(flat[k]) for k in opt.names])
        assert opt.count.dtype == torch.int32 and opt.count.device == opt.params[0].device
        want = flatten(jax.tree.map(np.asarray, params))
        for k, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=0, atol=1e-7,
                                       err_msg=f"update {i + 1}: {k}")
    leaves = [np.asarray(x) for x in jax.tree.leaves(jstate)]
    ours = opt.state_leaves()
    assert len(ours) == len(leaves)
    np.testing.assert_array_equal(ours[0], leaves[0])
    if schedule == "cosine":
        np.testing.assert_array_equal(ours[-1], leaves[-1])


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_lr_schedule_on_the_device_matches_optax(schedule):
    """Every count of a run and past its end, in float32: the warm-up from
    0, the cosine decay to lr / 100 and its floor; a float32 0-d tensor on
    the count's device."""
    t = dataclasses.replace(config.config4().train, lr_schedule=schedule, warmup_steps=4,
                            steps=20, lr=3e-3)
    want = (optax.warmup_cosine_decay_schedule(0.0, t.lr, t.warmup_steps, t.steps, t.lr / 100.0)
            if schedule == "cosine" else optax.constant_schedule(t.lr))
    fn = train.lr_schedule(config.config4().replace(train=t))
    for c in range(26):
        got = fn(torch.tensor(c, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(got.item(), np.float32(want(c)), rtol=1e-6, atol=1e-12,
                                   err_msg=f"count {c}")


def test_the_count_saturates_at_int32_max():
    cfg = config.config4().replace(model=config.ModelConfig(**SMALL),
                                   train=dataclasses.replace(config.config4().train,
                                                             lr_schedule="constant"))
    model = Forecaster(cfg.model, TO, TP, device="cpu", generator=torch.Generator().manual_seed(0))
    opt = train.make_optimizer(cfg, model)
    opt.count.fill_(train.INT32_MAX - 1)
    for _ in range(2):
        opt.step([torch.ones_like(p) for p in opt.params])
    assert int(opt.count) == train.INT32_MAX
    assert all(torch.isfinite(p).all() for p in opt.params)
