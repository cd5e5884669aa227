"""The port's training loop and ``cli train`` on the CPU, at a tiny size.

The data are five small random-walk scenes written here (never read through
the JAX package's registry); the model is config 4 cut to hidden 16, 2
heads, N_max 8, obs 4 and pred 3.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from mmtraj_torch import cli, config, train
from mmtraj_torch.data.transforms import NormStats
from mmtraj_torch.models.forecaster import Forecaster
from mmtraj_torch.params import load_npz
from torch_jax_streams import SMALL, TO, TP, write_scenes

torch.set_num_threads(2)


def _cfg(data_dir, out_dir, **train_kw):
    cfg = config.config4()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, **SMALL),
        data=dataclasses.replace(cfg.data, data_dir=data_dir, n_max=8, obs_len=TO, pred_len=TP),
        train=dataclasses.replace(cfg.train, **{
            "batch_size": 4, "eval_every": 0, "log_every": 1, "k_samples": 2,
            "out_dir": out_dir, **train_kw}))


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return write_scenes(tmp_path_factory.mktemp("scenes"))


def test_resumed_fit_is_bit_identical_to_an_uninterrupted_one(data_dir, tmp_path):
    """Hybrid loss with dropout, augment and EMA; the interrupted run stops at
    step 3 (a checkpoint), and the resumed one replays steps 4-7 (across an
    epoch boundary: 4 scenes of 10 windows is 10 batches of 4)."""
    kw = dict(loss="hybrid", variety_n=2, augment_rotate=True, augment_flip=True,
              ema_decay=0.9, ckpt_every=3)
    base = _cfg(data_dir, str(tmp_path / "a"), steps=12, **kw)
    base = base.replace(model=dataclasses.replace(base.model, dropout=0.1))
    whole = train.fit(base, device="cpu")
    cut = base.replace(train=dataclasses.replace(base.train, steps=3,
                                                 out_dir=str(tmp_path / "b")))
    train.fit(cut, device="cpu")
    resumed = train.fit(cut.replace(train=dataclasses.replace(cut.train, steps=12)),
                        resume=True, device="cpu")
    assert sorted(whole.state) == sorted(resumed.state)
    for k in whole.state:
        assert torch.equal(whole.state[k], resumed.state[k]), k
    a, b = load_npz(str(tmp_path / "a" / "checkpoint.npz")), load_npz(
        str(tmp_path / "b" / "checkpoint.npz"))
    assert a.step == b.step == 12
    for x, y in zip(a.opt_leaves, b.opt_leaves):
        np.testing.assert_array_equal(x, y)
    assert whole.history[-4:] == resumed.history[-4:]
    assert whole.eval_metrics == resumed.eval_metrics
    assert os.path.exists(tmp_path / "a" / "checkpoint_ema.npz")
    records = [json.loads(line) for line in open(tmp_path / "b" / "metrics.jsonl")]
    assert [r.get("event") for r in records if "event" in r][:2] == ["setup", "checkpoint"]
    assert any(r.get("event") == "resume" for r in records)


@pytest.mark.parametrize("change, match", [
    (dict(stream=True), "item 6"),
    (dict(data_parallel=True), "item 6"),
])
def test_fit_options_not_ported_raise(data_dir, tmp_path, change, match):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue 1: {match}"):
        train.fit(_cfg(data_dir, str(tmp_path), steps=1, **change), device="cpu")


def _loop(mc, xy, mask, steps, loss_mode="nll"):
    cfg = config.config4().replace(model=mc)
    model = Forecaster(mc, TO, TP, device="cpu", generator=torch.Generator().manual_seed(0))
    stats = NormStats(np.zeros(2, np.float32), np.full(2, 0.3, np.float32))
    step = train.make_train_step(model, train.make_optimizer(cfg, model), stats,
                                 loss_mode=loss_mode, variety_n=2)
    return model, [float(step(xy, mask, s)) for s in range(steps)]


@pytest.mark.parametrize("loss_mode", ["nll", "hybrid"])
def test_all_padding_batch_gives_zero_loss_and_finite_gradients(loss_mode):
    mc = config.ModelConfig(**SMALL, remat=True)
    xy, mask = torch.zeros(2, 8, TO + TP, 2), torch.zeros(2, 8, dtype=torch.bool)
    model, losses = _loop(mc, xy, mask, 1, loss_mode)
    assert losses == [0.0]
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


def test_sixty_steps_clearly_lower_the_loss():
    rng = np.random.default_rng(1)
    vel = rng.normal(scale=0.3, size=(6, 8, 1, 2))
    xy = torch.tensor(vel * np.arange(TO + TP)[None, None, :, None]
                      + rng.normal(scale=0.02, size=(6, 8, TO + TP, 2)), dtype=torch.float32)
    mask = torch.tensor(rng.random((6, 8)) < 0.8)
    _, losses = _loop(config.ModelConfig(**SMALL, remat=True), xy, mask, 60)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 1.0, losses


def test_cli_train_writes_a_checkpoint_that_cli_eval_reads(data_dir, tmp_path, capsys):
    out = str(tmp_path / "run")
    code = cli.main(["train", "--config", "4", "--data-dir", data_dir, "--n-max", "8",
                     "--obs-len", str(TO), "--pred-len", str(TP), "--hidden-dim", "16",
                     "--num-heads", "2", "--steps", "3", "--batch-size", "4", "--k", "2",
                     "--out-dir", out, "--loss", "hybrid", "--variety-n", "2", "--augment",
                     "--device", "cpu"])
    assert code == 0
    assert "final: best-of-2" in capsys.readouterr().out
    ck = load_npz(os.path.join(out, "checkpoint.npz"))
    assert ck.step == 3 and ck.config.model.hidden_dim == 16 and ck.opt_leaves
    assert ck.config.train.augment_rotate and ck.config.train.loss == "hybrid"
    code = cli.main(["eval", "--ckpt", os.path.join(out, "checkpoint.npz"), "--device", "cpu"])
    assert code == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("scene=univ step=3 ") and "best-of-2 (per_agent)" in line
