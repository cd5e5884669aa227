"""The port's pooled evaluation protocols, checkpoints and ``eval`` command
against the JAX package, on the CPU.

``tta=2``, an ensemble of 2, shape ``buckets`` and ``evaluate_mixed``: the
port fed JAX's per-window streams through ``mmtraj_torch.evaluate.window_stream``
against JAX ``evaluate``, min-ADE/FDE and NLL within 1e-4, rates and counts
equal.  ``save_npz`` read back by the JAX package's ``load_npz``.
``mmtraj_torch.cli eval --device cpu`` on a checkpoint written by the JAX
package prints JAX ``mmtraj.cli`` eval's line, the numbers to 4 decimals.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch

from mmtraj import checkpoint as j_checkpoint
from mmtraj import cli as j_cli
from mmtraj.config import Config as JConfig
from mmtraj.config import DataConfig as JDataConfig
from mmtraj.config import ModelConfig as JModelConfig
from mmtraj.config import TrainConfig as JTrainConfig
from mmtraj.data.collate import WindowDataset as JWindowDataset
from mmtraj.data.parser import read_annotation_file as j_read_annotation_file
from mmtraj.data.transforms import NormStats as JNormStats
from mmtraj.data.windower import make_windows as j_make_windows
from mmtraj.evaluate import evaluate as j_evaluate
from mmtraj.evaluate import vmem_friendly_batch as j_vmem_friendly_batch
from mmtraj.models.forecaster import Forecaster as JForecaster
from mmtraj_torch import cli
from mmtraj_torch import evaluate as ev
from mmtraj_torch.config import ModelConfig, config_from_json
from mmtraj_torch.data.collate import WindowDataset
from mmtraj_torch.data.transforms import NormStats
from mmtraj_torch.models.forecaster import Forecaster
from mmtraj_torch.params import from_jax, load_npz, save_npz
from torch_jax_streams import SMALL, TO, TP, jax_window_stream, random_windows

torch.set_num_threads(2)

METRIC_TOL = 1e-4
K = 3
COUNTS = [2, 6, 3, 8, 2, 5, 1, 4, 7, 3, 2]  # 11 windows; buckets (4, 8) split them
STATS = (np.zeros(2, np.float32), np.full(2, 0.3, np.float32))


@pytest.fixture(scope="module")
def setup():
    jm = JForecaster(JModelConfig(**SMALL), TO, TP)
    params = [jm.init(jax.random.PRNGKey(0)), jm.init(jax.random.PRNGKey(7))]
    models = [Forecaster(ModelConfig(**SMALL), TO, TP, device="cpu",
                         state=from_jax(jax.tree.map(np.asarray, p))) for p in params]
    windows = random_windows(np.random.default_rng(5), COUNTS)
    return dict(jm=jm, params=params, models=models,
                jds=JWindowDataset(windows, 8), ds=WindowDataset(windows, 8))


def _assert_metrics_match(got, want):
    assert set(got) == set(want)
    for key in ("min_ade", "min_fde", "nll"):
        assert abs(got[key] - want[key]) <= METRIC_TOL, (key, got[key], want[key])
    for key in set(want) - {"min_ade", "min_fde", "nll"}:
        assert got[key] == want[key], (key, got[key], want[key])


def _both(setup, monkeypatch, ensemble=False, **protocol):
    """JAX evaluate and the port's on JAX's streams, same windows and flags."""
    params = setup["params"] if ensemble else setup["params"][0]
    models = setup["models"] if ensemble else setup["models"][0]
    want = j_evaluate(setup["jm"], params, JNormStats(*STATS), setup["jds"], k=K,
                      batch_size=4, seed=0, **protocol)
    monkeypatch.setattr(ev, "window_stream", jax_window_stream(setup["jm"]))
    got = ev.evaluate(models, NormStats(*STATS), setup["ds"], k=K, batch_size=4, seed=0,
                      **protocol)
    return got, want


@pytest.mark.parametrize("protocol", [
    dict(tta=2), dict(ensemble=True), dict(buckets=(4, 8)),
], ids=["tta2", "ensemble2", "buckets"])
def test_pooled_protocols_match_jax(protocol, setup, monkeypatch):
    got, want = _both(setup, monkeypatch, **protocol)
    _assert_metrics_match(got, want)


def test_buckets_equal_padded_on_own_streams(setup):
    """The bucketed run draws every window's stream at the full capacity,
    so its metrics are the padded run's."""
    model, stats = setup["models"][0], NormStats(*STATS)
    padded = ev.evaluate(model, stats, setup["ds"], k=K, batch_size=4, oversample=2)
    bucketed = ev.evaluate(model, stats, setup["ds"], k=K, batch_size=4, oversample=2,
                           buckets=(2, 4))
    assert bucketed["buckets"] == [2, 4, 8]
    for key in ("min_ade", "min_fde", "miss_rate_2m", "collision_rate", "nll"):
        np.testing.assert_allclose(bucketed[key], padded[key], rtol=1e-6, err_msg=key)


def test_evaluate_mixed_matches_evaluate_and_jax(setup, monkeypatch):
    """One member reproduces evaluate (and JAX's evaluate); two members of
    one configuration reproduce evaluate's ensemble."""
    got, want = _both(setup, monkeypatch)
    stats = NormStats(*STATS)
    one = ev.evaluate_mixed(setup["models"][:1], stats, setup["ds"], k=K, batch_size=4)
    assert one.pop("ensemble") == 1
    assert one == got
    _assert_metrics_match(one, want)
    two = ev.evaluate_mixed(setup["models"], stats, setup["ds"], k=K, batch_size=4, tta=2)
    pooled = ev.evaluate(setup["models"], stats, setup["ds"], k=K, batch_size=4, tta=2)
    assert two == pooled


@pytest.mark.parametrize("case", ["empty", "deterministic", "horizon", "reduction"])
def test_evaluate_mixed_guards(case, setup):
    members, kw = list(setup["models"]), {}
    if case == "empty":
        members = []
    elif case == "deterministic":
        members.append(Forecaster(ModelConfig(**SMALL, head="deterministic"), TO, TP,
                                  device="cpu", generator=torch.Generator().manual_seed(0)))
    elif case == "horizon":
        members.append(Forecaster(ModelConfig(**SMALL), TO, TP + 1, device="cpu",
                                  generator=torch.Generator().manual_seed(0)))
    else:
        kw = dict(reduction="bogus")
    with pytest.raises(ValueError):
        ev.evaluate_mixed(members, NormStats(*STATS), setup["ds"], k=K, **kw)


@pytest.mark.parametrize("k, n", [(20, 64), (1, 64), (20, 32), (20, 512), (60, 8), (5, 128)])
def test_vmem_friendly_batch_is_the_jax_default(k, n):
    for bpe in (2, 4):
        assert ev.vmem_friendly_batch(k, n, bytes_per_elem=bpe) == j_vmem_friendly_batch(
            k, n, bytes_per_elem=bpe)


def test_autotune_eval_batch_returns_a_candidate(setup, capsys):
    best = ev.autotune_eval_batch(setup["models"][0], NormStats(*STATS), n_max=8, k=K,
                                  iters=2, candidates=(1, 3))
    assert best in (1, 3)
    assert "best eval batch" in capsys.readouterr().out


# -- checkpoints and the eval command ---------------------------------------------------

def _jax_config(data_dir):
    return JConfig(model=JModelConfig(**SMALL),
                   data=JDataConfig(data_dir=data_dir, scene="zara1", obs_len=TO, pred_len=TP,
                                    n_max=8),
                   train=JTrainConfig(k_samples=K))


def test_save_npz_is_read_back_by_jax(setup, tmp_path):
    path = str(tmp_path / "port.npz")
    model = setup["models"][1]
    cfg = config_from_json(j_checkpoint.config_to_json(_jax_config("d")))
    stats = NormStats(torch.tensor([0.1, 0.2]), torch.tensor([1.0, 2.0]))
    save_npz(path, model.state_dict(), stats, cfg, step=17)
    assert sorted(os.listdir(tmp_path)) == ["port.npz"]
    ck = j_checkpoint.load_npz(path)
    assert ck.step == 17 and ck.config == _jax_config("d")
    np.testing.assert_array_equal(ck.stats.mean, np.array([0.1, 0.2], np.float32))
    want = jax.tree.map(np.asarray, setup["params"][1])
    got = jax.tree.map(np.asarray, ck.params)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    back = load_npz(path)
    assert back.step == 17 and back.config == cfg
    for key, value in model.state_dict().items():
        torch.testing.assert_close(back.state[key], value, atol=0, rtol=0)


def _write_scene(path, rng, n_peds=7, n_frames=30):
    """A scene file in the annotation format: each pedestrian walks over a
    random span of frames (frame ids step 10, as in ETH/UCY)."""
    rows = []
    for ped in range(n_peds):
        start = int(rng.integers(0, n_frames - TO - TP))
        stop = int(rng.integers(start + TO + TP, n_frames + 1))
        xy = np.cumsum(rng.normal(size=(stop - start, 2)) * 0.3, axis=0) + rng.normal(size=2) * 2
        rows += [(10 * f, ped, *xy[f - start]) for f in range(start, stop)]
    with open(path, "w") as f:
        f.writelines(f"{fr}\t{p}\t{x:.4f}\t{y:.4f}\n" for fr, p, x, y in rows)


_LINE = re.compile(r"([\w@.]+)=([-\d.]+)m?")


@pytest.mark.parametrize("flags", [[], ["--rollout", "modes"]], ids=["sample", "modes"])
def test_cli_eval_prints_the_jax_line(flags, setup, tmp_path, monkeypatch, capsys):
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    _write_scene(data_dir / "zara1.txt", np.random.default_rng(11))
    ckpt = str(tmp_path / "ckpt.npz")
    j_checkpoint.save_npz(ckpt, setup["params"][0], JNormStats(*STATS), _jax_config(str(data_dir)),
                          step=5)
    argv = ["eval", "--ckpt", ckpt, "--batch-size", "4"] + flags

    # JAX's eval, reading the scene with its numpy parser.
    def load_eval_dataset(cfg, auto_n_max, context):
        rows = j_read_annotation_file(os.path.join(cfg.data.data_dir, f"{cfg.data.scene}.txt"))
        windows = j_make_windows(rows, cfg.data.obs_len, cfg.data.pred_len)
        return JWindowDataset(windows, cfg.data.n_max), cfg.data.n_max

    monkeypatch.setenv("MMTRAJ_COMPILE_CACHE", "off")
    monkeypatch.setattr(j_cli, "_load_eval_dataset", load_eval_dataset)
    assert j_cli.main(argv) == 0
    want = capsys.readouterr().out.strip().splitlines()[-1]

    monkeypatch.setattr(ev, "window_stream", jax_window_stream(setup["jm"]))
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert _LINE.sub("", got) == _LINE.sub("", want)
    got_nums, want_nums = dict(_LINE.findall(got)), dict(_LINE.findall(want))
    assert got_nums.keys() == want_nums.keys() and "ADE" in got_nums
    for key, value in want_nums.items():
        assert abs(float(got_nums[key]) - float(value)) <= 1e-4, (key, got, want)


@pytest.mark.parametrize("flags", [
    ["--data-parallel"], ["--dtype", "bfloat16"], ["--ckpt", "model.pt"],
], ids=["data-parallel", "bfloat16", "torch-checkpoint"])
def test_cli_unported_options_raise(flags):
    argv = ["eval", "--ckpt", "missing.npz", "--device", "cpu"] + flags
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1: item"):
        cli.main(argv)
