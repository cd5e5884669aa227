"""The port's checkpoint formats and ``load``'s dispatch, against the JAX
package's ``mmtraj/checkpoint.py``, on the CPU.

Every format round-trips the state, stats, config and step to the bit, and a
file written by either package reads in the other to the bit.  Every failure
``tests/test_checkpoint.py`` pins for the JAX package raises the port's
``CheckpointError`` naming the file, the parse error chained; an Orbax
directory, which the port does not read, names the JAX package's converter.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mmtraj import checkpoint as j_checkpoint
from mmtraj import config as jconfig
from mmtraj.data.transforms import NormStats as JNormStats
from mmtraj.models.forecaster import init_params as j_init_params
from mmtraj_torch import checkpoint as ck
from mmtraj_torch.config import config_from_json
from mmtraj_torch.data.transforms import NormStats
from mmtraj_torch.params import flatten, from_jax
from torch_jax_streams import SMALL

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
MEAN, STD = np.array([0.1, -0.2], np.float32), np.array([0.4, 0.5], np.float32)
SUFFIXES = [".npz", ".pt", ".pth", ".h5", ".hdf5"]
JAX_SAVERS = {".npz": j_checkpoint.save_npz, ".pt": j_checkpoint.save_torch,
              ".h5": j_checkpoint.save_h5}


@pytest.fixture(scope="module")
def payload():
    """JAX parameters of a small config 4 with its config, and the port's
    state, stats and config for the same."""
    jcfg = jconfig.config4().replace(model=jconfig.ModelConfig(**SMALL))
    params = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(3), jcfg.model))
    cfg = config_from_json(j_checkpoint.config_to_json(jcfg))
    return dict(params=params, jcfg=jcfg, state=from_jax(params), cfg=cfg,
                stats=NormStats(MEAN, STD))


def _assert_same(got, state, stats, cfg, step):
    assert sorted(got.state) == sorted(state)
    for k, v in state.items():
        assert got.state[k].dtype == torch.float32
        assert torch.equal(got.state[k], v), k
    np.testing.assert_array_equal(np.asarray(got.stats.mean), np.asarray(stats.mean))
    np.testing.assert_array_equal(np.asarray(got.stats.std), np.asarray(stats.std))
    assert got.config == cfg and got.step == step


@pytest.mark.parametrize("suffix", SUFFIXES)
def test_roundtrip_by_suffix(payload, tmp_path, suffix):
    path = str(tmp_path / f"c{suffix}")
    ck.save(path, payload["state"], payload["stats"], payload["cfg"], step=7)
    assert sorted(os.listdir(tmp_path)) == [f"c{suffix}"]  # no temporary file left
    _assert_same(ck.load(path), payload["state"], payload["stats"], payload["cfg"], 7)


def test_roundtrip_from_device_state_and_tensor_stats(payload, tmp_path):
    """A model's state_dict (parameters that require grad) and tensor stats,
    as ``fit`` and ``chip_smoke.py`` hold them."""
    from mmtraj_torch.models.forecaster import Forecaster

    model = Forecaster(payload["cfg"].model, 8, 12, device="cpu", state=payload["state"])
    stats = NormStats(torch.from_numpy(MEAN), torch.from_numpy(STD))
    for suffix in (".pt", ".h5"):
        path = str(tmp_path / f"m{suffix}")
        ck.save(path, dict(model.named_parameters()), stats, payload["cfg"], step=2)
        _assert_same(ck.load(path), payload["state"], payload["stats"], payload["cfg"], 2)


@pytest.mark.parametrize("suffix", sorted(JAX_SAVERS))
def test_a_jax_file_reads_in_the_port(payload, tmp_path, suffix):
    path = str(tmp_path / f"jax{suffix}")
    JAX_SAVERS[suffix](path, payload["params"], JNormStats(MEAN, STD), payload["jcfg"], step=11)
    _assert_same(ck.load(path), payload["state"], payload["stats"], payload["cfg"], 11)


@pytest.mark.parametrize("suffix", sorted(JAX_SAVERS))
def test_a_port_file_reads_in_jax(payload, tmp_path, suffix):
    path = str(tmp_path / f"port{suffix}")
    ck.save(path, payload["state"], NormStats(torch.from_numpy(MEAN), torch.from_numpy(STD)),
            payload["cfg"], step=13)
    got = j_checkpoint.load(path)
    assert got.step == 13 and got.config == payload["jcfg"]
    np.testing.assert_array_equal(np.asarray(got.stats.mean), MEAN)
    np.testing.assert_array_equal(np.asarray(got.stats.std), STD)
    want = flatten(payload["params"])
    got_flat = flatten(jax.tree.map(np.asarray, got.params))
    assert sorted(got_flat) == sorted(want)
    for k, v in want.items():
        assert got_flat[k].dtype == np.float32
        np.testing.assert_array_equal(got_flat[k], v, err_msg=k)


def test_npz_keeps_the_optimizer_leaves(payload, tmp_path):
    path = str(tmp_path / "opt.npz")
    leaves = [np.arange(3, dtype=np.float32), np.int32(4)]
    ck.save(path, payload["state"], payload["stats"], payload["cfg"], 5, opt_leaves=leaves)
    got = ck.load(path)
    assert len(got.opt_leaves) == 2
    np.testing.assert_array_equal(got.opt_leaves[0], leaves[0])
    assert int(got.opt_leaves[1]) == 4


def test_save_opt_leaves_requires_npz(payload, tmp_path):
    """The other formats carry no optimizer state: passing one is an error,
    not a checkpoint that would resume with a fresh optimizer."""
    for name in ("c.pt", "c.h5", "orbax_dir"):
        with pytest.raises(ValueError, match="opt_leaves"):
            ck.save(str(tmp_path / name), payload["state"], payload["stats"], payload["cfg"], 0,
                    opt_leaves=[np.zeros(3, np.float32)])
    assert not os.listdir(tmp_path)


def test_save_to_an_unknown_suffix_raises(payload, tmp_path):
    with pytest.raises(ValueError, match=r"\.npz, \.pt"):
        ck.save(str(tmp_path / "orbax_dir"), payload["state"], payload["stats"], payload["cfg"])


@pytest.mark.parametrize("suffix", [".npz", ".pt", ".h5"])
def test_corrupt_file_raises_checkpoint_error(tmp_path, suffix):
    path = str(tmp_path / f"bad{suffix}")
    with open(path, "wb") as f:
        f.write(b"this is not a checkpoint at all" * 8)
    with pytest.raises(ck.CheckpointError) as ei:
        ck.load(path)
    assert f"bad{suffix}" in str(ei.value)
    assert ei.value.__cause__ is not None


def test_truncated_npz_raises_with_cause(payload, tmp_path):
    path = str(tmp_path / "t.npz")
    ck.save(path, payload["state"], payload["stats"], payload["cfg"])
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw[: len(raw) // 2])
    with pytest.raises(ck.CheckpointError) as ei:
        ck.load(path)
    assert ".npz" in str(ei.value) and ei.value.__cause__ is not None


@pytest.mark.parametrize("suffix, name", [(".npz", "weights_final"), (".h5", "model_keras")])
def test_suffixless_file_sniffed_by_magic(payload, tmp_path, suffix, name):
    src = str(tmp_path / f"c{suffix}")
    ck.save(src, payload["state"], payload["stats"], payload["cfg"], step=9)
    plain = str(tmp_path / name)
    os.rename(src, plain)
    _assert_same(ck.load(plain), payload["state"], payload["stats"], payload["cfg"], 9)


def test_implicit_npz_suffix_and_the_named_file_wins(payload, tmp_path):
    bare = str(tmp_path / "ckpt")
    ck.save(bare + ".npz", payload["state"], payload["stats"], payload["cfg"], step=1)
    assert ck.load(bare).step == 1  # only ckpt.npz exists
    with open(bare, "wb") as f:  # now the bare file exists too, and it is read
        f.write(b"JUNKDATA")
    with pytest.raises(ck.CheckpointError, match="magic"):
        ck.load(bare)


def test_unknown_magic_is_actionable(tmp_path):
    path = str(tmp_path / "mystery")
    with open(path, "wb") as f:
        f.write(b"JUNKDATA")
    with pytest.raises(ck.CheckpointError, match="magic"):
        ck.load(path)


def test_missing_path_raises_checkpoint_error(tmp_path):
    with pytest.raises(ck.CheckpointError, match="does_not_exist") as ei:
        ck.load(str(tmp_path / "does_not_exist"))
    assert isinstance(ei.value.__cause__, FileNotFoundError)


def test_an_orbax_directory_names_the_converter(tmp_path):
    path = tmp_path / "orbax_ckpt"
    path.mkdir()
    (path / "mmtraj_config.json").write_text("{}")
    with pytest.raises(ck.CheckpointError, match="python -m mmtraj.cli convert --src"):
        ck.load(str(path))


def test_the_module_imports_without_h5py(payload, tmp_path):
    """h5py is imported only to read or write an .h5: without it the module
    imports, the other formats work, and an .h5 raises CheckpointError with
    the ImportError chained."""
    path = str(tmp_path / "c.h5")
    ck.save(path, payload["state"], payload["stats"], payload["cfg"])
    script = (
        "import sys\n"
        "sys.modules['h5py'] = None\n"
        "import mmtraj_torch.checkpoint as ck\n"
        "import mmtraj_torch.interop\n"
        "try:\n"
        f"    ck.load({path!r})\n"
        "except ck.CheckpointError as e:\n"
        "    assert isinstance(e.__cause__, ImportError), e.__cause__\n"
        "    print('ok', type(e.__cause__).__name__)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().startswith("ok")
