"""``python -m mmtraj_torch.cli predict`` against the JAX package's
``predict``: the written ``.npz`` keys, each window's K futures against JAX
``rollout_k(keys=...)`` on the same windows with the JAX package's
per-window keys fold_in(PRNGKey(seed), window), and invariance to
``--batch-size``.

The port draws each window's stream through ``evaluate.window_stream``; the
parity cases hand it JAX's streams for the same keys
(``tests/torch_jax_streams.py``).  The windows come from annotation files
read by the port's own data path (never ``mmtraj.data.registry``, whose
native parser races under ``pytest -n``).  Tolerance 1e-4 m on valid agents,
the port's trajectory tolerance.
"""

import jax
import numpy as np
import pytest
import torch

import mmtraj_torch.evaluate as ev
from mmtraj.config import ModelConfig as JModelConfig
from mmtraj.data.transforms import NormStats as JNormStats
from mmtraj.models.forecaster import Forecaster as JForecaster
from mmtraj.models.sampling import diverse_select as j_diverse_select
from mmtraj_torch.cli import main
from mmtraj_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from mmtraj_torch.data.transforms import NormStats
from mmtraj_torch.params import from_jax, save_npz
from torch_jax_streams import TO, TP, jax_window_stream, write_scenes

torch.set_num_threads(2)

SMALL = dict(num_heads=2, embed_dim=8, hidden_dim=16, num_mixtures=2)
K, N_MAX, SCENE = 3, 8, "univ"
STATS = NormStats(np.array([0.01, -0.02], np.float32), np.array([0.4, 0.5], np.float32))
TRAJ = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(jax model, its params, checkpoint path, data dir)."""
    root = tmp_path_factory.mktemp("predict")
    data = write_scenes(root, frames=18)
    jm = JForecaster(JModelConfig(**SMALL), TO, TP)
    params = jm.init(jax.random.PRNGKey(0))
    cfg = Config(model=ModelConfig(**SMALL),
                 data=DataConfig(data_dir=data, scene=SCENE, obs_len=TO, pred_len=TP,
                                 n_max=N_MAX),
                 train=TrainConfig(k_samples=K))
    ckpt = str(root / "ckpt.npz")
    save_npz(ckpt, from_jax(jax.tree.map(np.asarray, params)), STATS, cfg)
    return jm, params, ckpt, data


def _predict(ckpt, out, *extra):
    assert main(["predict", "--ckpt", ckpt, "--out", str(out), "--seed", "3", "--device", "cpu",
                 *extra]) == 0
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("oversample", [1, 3])
def test_predict_matches_jax_per_window(oversample, setup, tmp_path, monkeypatch, capsys):
    jm, params, ckpt, _ = setup
    monkeypatch.setattr(ev, "window_stream", jax_window_stream(jm))
    got = _predict(ckpt, tmp_path / "p.npz", "--batch-size", "4", "--oversample",
                   str(oversample))
    assert "wrote" in capsys.readouterr().out
    want_keys = {"predictions", "mask", "obs_len", "pred_len", "scene", "k"}
    assert set(got) == want_keys | ({"oversample"} if oversample > 1 else set())
    assert (int(got["obs_len"]), int(got["pred_len"]), str(got["scene"]), int(got["k"])) == \
        (TO, TP, SCENE, K)
    preds, mask = got["predictions"], got["mask"]
    W = mask.shape[0]
    assert W > 4 and preds.shape == (K, W, N_MAX, TP, 2)

    from mmtraj_torch.data.collate import WindowDataset
    from mmtraj_torch.data.registry import load_scene_windows

    ds = WindowDataset(load_scene_windows(setup[3], SCENE, TO, TP, 1, 1), N_MAX)
    np.testing.assert_array_equal(ds.mask, mask)
    key = jax.random.PRNGKey(3)
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(np.arange(W, dtype=np.int32))
    want = jm.rollout_k(params, ds.xy[:, :, :TO], ds.mask, JNormStats(*STATS), None,
                        K * oversample, keys=keys)
    if oversample > 1:
        want = j_diverse_select(want, K)
    np.testing.assert_allclose(preds[:, mask], np.asarray(want)[:, mask], **TRAJ)


def test_predict_does_not_depend_on_batch_size(setup, tmp_path):
    _, _, ckpt, _ = setup
    runs = [_predict(ckpt, tmp_path / f"{b}.npz", *(["--batch-size", b] if b else []))
            for b in ("1", "3", None)]
    for r in runs[1:]:
        np.testing.assert_array_equal(r["predictions"], runs[0]["predictions"])
        np.testing.assert_array_equal(r["mask"], runs[0]["mask"])
    other = _predict(ckpt, tmp_path / "seed.npz", "--seed", "4")
    assert not np.allclose(other["predictions"], runs[0]["predictions"])


def test_predict_oversample_needs_the_gmm_head(setup, tmp_path, capsys):
    _, _, _, data = setup
    cfg = Config(model=ModelConfig(**{**SMALL, "head": "deterministic", "num_heads": 1}),
                 data=DataConfig(data_dir=data, scene=SCENE, obs_len=TO, pred_len=TP,
                                 n_max=N_MAX))
    from mmtraj_torch.models.forecaster import Forecaster

    model = Forecaster(cfg.model, TO, TP, device="cpu", generator=torch.Generator())
    ckpt = str(tmp_path / "det.npz")
    save_npz(ckpt, model.state_dict(), STATS, cfg)
    with pytest.raises(SystemExit):
        main(["predict", "--ckpt", ckpt, "--out", str(tmp_path / "x.npz"), "--oversample", "2",
              "--device", "cpu"])
    assert "(GMM) head" in capsys.readouterr().err
