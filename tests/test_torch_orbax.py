"""Orbax directories in the port (``mmtraj_torch.checkpoint.load_orbax`` /
``save_orbax``, ``mmtraj_torch/orbax_io``) against the JAX package, which
writes and reads them through orbax and tensorstore.

* A directory the JAX package's ``save_orbax`` writes (zarr arrays in an
  OCDBT store, zstd chunks) reads in the port equal to JAX's ``load``, to the
  bit: config 4, the attention encoder and the LSTM of config 1, at step 0
  and 2**40; and the committed fixture equals its ``.npz`` twin in both.
* A directory the port writes (orbax's layout without OCDBT) reads in JAX's
  ``load`` to the bit, and in the port's.
* ``cli convert`` from a JAX directory gives the arrays JAX's ``convert``
  gives; a model loaded from one rolls out within 1e-4 m of JAX's rollout
  on the same stream.
* Corrupt directories raise ``CheckpointError`` with the cause chained.
* The zarr reader takes each dtype, byte order, order, separator and chunk
  grid that tensorstore writes, and a missing chunk as tensorstore reads it.
"""

import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import tensorstore as ts
import torch

import torch_orbax_fixture as fixture
from mmtraj import checkpoint as j_checkpoint
from mmtraj import cli as j_cli
from mmtraj import config as jconfig
from mmtraj.data.transforms import NormStats as JNormStats
from mmtraj.models.forecaster import Forecaster as JForecaster
from mmtraj.models.forecaster import init_params as j_init_params
from mmtraj_torch import checkpoint as ck
from mmtraj_torch import cli
from mmtraj_torch.config import config_from_json
from mmtraj_torch.data.transforms import NormStats
from mmtraj_torch.models.forecaster import Forecaster
from mmtraj_torch.orbax_io import zarr
from mmtraj_torch.params import flatten

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
MEAN, STD = np.array([0.1, -0.2], np.float32), np.array([0.4, 0.5], np.float32)
CONFIGS = {
    "config4": jconfig.config4,
    "attn": lambda: jconfig.config4().replace(
        model=dataclasses.replace(jconfig.config4().model, encoder="attn")),
    "config1_lstm": jconfig.config1,
}


def _jax_flat(params):
    return flatten(jax.tree.map(np.asarray, params))


def _assert_port_equals_jax(got, want):
    """A port ``Checkpoint`` against a JAX one, to the bit."""
    want_flat = _jax_flat(want.params)
    assert sorted(got.state) == sorted(want_flat)
    for k, v in want_flat.items():
        assert got.state[k].dtype == torch.float32 and v.dtype == np.float32, k
        np.testing.assert_array_equal(got.state[k].numpy(), v, err_msg=k)
    for a, b in ((got.stats.mean, want.stats.mean), (got.stats.std, want.stats.std)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    assert got.step == want.step
    assert got.config == config_from_json(j_checkpoint.config_to_json(want.config))


def _jax_save(path, name, step):
    jcfg = CONFIGS[name]()
    params = j_init_params(jax.random.PRNGKey(1), jcfg.model)
    j_checkpoint.save_orbax(str(path), params, JNormStats(MEAN, STD), jcfg, step=step)
    return jcfg


# -- the committed fixture -------------------------------------------------------------------

def test_the_fixture_equals_its_twin_in_jax():
    """JAX's ``load`` of the directory equals JAX's ``load`` of the twin, so a
    regenerated fixture cannot drift from what ``chip_smoke.py`` reads.  No
    ``torch_orbax_c4.npz`` may sit beside the directory: ``load`` would read
    that file instead."""
    assert not os.path.exists(str(fixture.ORBAX_DIR) + ".npz")
    got = j_checkpoint.load(str(fixture.ORBAX_DIR))
    twin = j_checkpoint.load(str(fixture.TWIN))
    assert got.step == twin.step == fixture.STEP and got.config == twin.config
    np.testing.assert_array_equal(np.asarray(got.stats.mean), fixture.MEAN)
    np.testing.assert_array_equal(np.asarray(got.stats.std), fixture.STD)
    a, b = _jax_flat(got.params), _jax_flat(twin.params)
    assert sorted(a) == sorted(b) and len(a) == 24
    assert sum(v.size for v in a.values()) == 72798
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_the_port_reads_the_fixture_equal_to_its_twin():
    got, twin = ck.load(str(fixture.ORBAX_DIR)), ck.load(str(fixture.TWIN))
    _assert_port_equals_jax(got, j_checkpoint.load(str(fixture.ORBAX_DIR)))
    assert sorted(got.state) == sorted(twin.state)
    for k, v in twin.state.items():
        assert torch.equal(got.state[k], v), k
    assert got.config == twin.config and got.step == twin.step


# -- JAX writes, the port reads; the port writes, JAX reads -------------------------------------

@pytest.mark.parametrize("step", [0, 2 ** 40])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_a_jax_orbax_directory_reads_in_the_port(tmp_path, name, step):
    _jax_save(tmp_path / "jax_ckpt", name, step)
    _assert_port_equals_jax(ck.load(str(tmp_path / "jax_ckpt")),
                            j_checkpoint.load(str(tmp_path / "jax_ckpt")))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_a_port_orbax_directory_reads_in_jax(tmp_path, name):
    _jax_save(tmp_path / "jax_ckpt", name, 2 ** 40)
    src = ck.load(str(tmp_path / "jax_ckpt"))
    stats = NormStats(torch.from_numpy(MEAN), torch.from_numpy(STD))
    ck.save(str(tmp_path / "port_ckpt"), src.state, stats, src.config, src.step)
    assert sorted(os.listdir(tmp_path)) == ["jax_ckpt", "port_ckpt"]  # nothing temporary left
    want = j_checkpoint.load(str(tmp_path / "jax_ckpt"))
    _assert_port_equals_jax(src, want)
    got = j_checkpoint.load(str(tmp_path / "port_ckpt"))
    assert got.step == 2 ** 40 and got.config == want.config
    a, b = _jax_flat(got.params), _jax_flat(want.params)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(np.asarray(got.stats.mean), MEAN)
    np.testing.assert_array_equal(np.asarray(got.stats.std), STD)


def test_the_port_round_trip_replaces_an_existing_directory(tmp_path):
    src = ck.load(str(fixture.TWIN))
    path = str(tmp_path / "ckpt")
    ck.save(path, src.state, src.stats, src.config, 1)
    (tmp_path / "ckpt" / "stale").write_text("from the first save")
    ck.save(path, src.state, src.stats, src.config, 2)
    assert sorted(os.listdir(tmp_path)) == ["ckpt"]
    assert not (tmp_path / "ckpt" / "stale").exists()
    got = ck.load(path)
    assert got.step == 2 and got.config == src.config
    for k, v in src.state.items():
        assert torch.equal(got.state[k], v), k


# -- cli convert and a model loaded from a JAX directory ------------------------------------------

def _quiet(fn, argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        code = fn(argv)
    return code, out.getvalue()


def test_cli_convert_from_a_jax_directory_matches_jax_convert(tmp_path):
    _jax_save(tmp_path / "jax_ckpt", "config4", 77)
    code, out = _quiet(cli.main, ["convert", "--src", str(tmp_path / "jax_ckpt"),
                                  "--dst", str(tmp_path / "port.npz")])
    assert code == 0 and "step=77" in out
    assert _quiet(j_cli.main, ["convert", "--src", str(tmp_path / "jax_ckpt"),
                               "--dst", str(tmp_path / "jax.npz")])[0] == 0
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype, k
    # and back: .npz -> a directory, which JAX reads
    code, _ = _quiet(cli.main, ["convert", "--src", str(tmp_path / "port.npz"),
                                "--dst", str(tmp_path / "back")])
    assert code == 0
    _assert_port_equals_jax(ck.load(str(tmp_path / "port.npz")),
                            j_checkpoint.load(str(tmp_path / "back")))


def test_a_model_from_a_jax_directory_rolls_out_as_jax_does(tmp_path):
    B, N, K, TO, TP = 2, 8, 3, 8, 12
    small = dict(hidden_dim=16, embed_dim=16, num_heads=2)
    jcfg = jconfig.config4().replace(model=jconfig.ModelConfig(**small))
    jm = JForecaster(jcfg.model, TO, TP)
    j_checkpoint.save_orbax(str(tmp_path / "c"), jm.init(jax.random.PRNGKey(4)),
                            JNormStats(MEAN, STD), jcfg, step=3)
    jck = j_checkpoint.load(str(tmp_path / "c"))
    rng = np.random.default_rng(0)
    xy_obs = np.cumsum(rng.normal(size=(B, N, TO, 2)).astype(np.float32) * 0.4, axis=2)
    mask = rng.random((B, N)) < 0.75
    key = jax.random.PRNGKey(5)
    want = np.asarray(jm.rollout_k(jck.params, xy_obs, mask, jck.stats, key, K))
    gumbel, normal = jm._rollout_stream(key, K * B, N)
    pck = ck.load(str(tmp_path / "c"))
    model = Forecaster(pck.config.model, TO, TP, device="cpu", state=pck.state)
    got = model.rollout_k(torch.from_numpy(xy_obs), torch.from_numpy(mask), pck.stats, K,
                          stream=(np.array(gumbel), np.array(normal)))
    assert got.shape == want.shape == (K, B, N, TP, 2)
    np.testing.assert_allclose(got.numpy()[:, mask], want[:, mask], atol=1e-4, rtol=1e-4)


# -- corrupt directories ------------------------------------------------------------------------

def _copy_fixture(tmp_path):
    dst = tmp_path / "copy"
    shutil.copytree(fixture.ORBAX_DIR, dst)
    return dst


def test_corrupt_orbax_dir_raises_checkpoint_error(tmp_path):
    """The counterpart of ``tests/test_checkpoint.py``'s: every JSON file but
    the config wrecked, the load raises ``CheckpointError``."""
    for path in (_copy_fixture(tmp_path / "a"), tmp_path / "b"):
        if not path.exists():
            src = ck.load(str(fixture.TWIN))
            ck.save(str(path), src.state, src.stats, src.config, 3)
        wrecked = 0
        for root, _, files in os.walk(path):
            for fn in files:
                if fn != ck.CONFIG_FILE and (fn.endswith(".json") or fn.startswith("_")
                                             or fn == ".zarray"):
                    Path(root, fn).write_text("{corrupt")
                    wrecked += 1
        assert wrecked >= 2
        with pytest.raises(ck.CheckpointError, match="as Orbax directory") as ei:
            ck.load(str(path))
        assert ei.value.__cause__ is not None


def test_a_flipped_node_byte_raises_naming_the_checksum(tmp_path):
    path = _copy_fixture(tmp_path)
    (node,) = os.listdir(path / "d")
    data = bytearray((path / "d" / node).read_bytes())
    data[len(data) // 2] ^= 0x01
    (path / "d" / node).write_bytes(bytes(data))
    with pytest.raises(ck.CheckpointError, match="as Orbax directory") as ei:
        ck.load(str(path))
    assert isinstance(ei.value.__cause__, ValueError)
    assert "CRC-32C checksum mismatch" in str(ei.value.__cause__) and node in str(ei.value)


def test_a_missing_config_raises(tmp_path):
    path = _copy_fixture(tmp_path)
    (path / ck.CONFIG_FILE).unlink()
    with pytest.raises(ck.CheckpointError, match="mmtraj_config.json") as ei:
        ck.load(str(path))
    assert isinstance(ei.value.__cause__, FileNotFoundError)


def test_the_modules_read_the_fixture_without_jax_orbax_or_tensorstore():
    script = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'orbax', 'orbax.checkpoint', 'tensorstore', 'zstandard',"
        " 'mmtraj'):\n"
        "    sys.modules[name] = None\n"
        "import mmtraj_torch.checkpoint as ck\n"
        "import mmtraj_torch.cli\n"
        f"got = ck.load({str(fixture.ORBAX_DIR)!r})\n"
        f"assert got.step == {fixture.STEP} and len(got.state) == 24\n"
        "print('ok', sum(v.numel() for v in got.state.values()))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok 72798"


# -- zarr arrays as tensorstore writes them ------------------------------------------------------

def _file_get(root):
    def get(key):
        path = os.path.join(root, key)
        return open(path, "rb").read() if os.path.isfile(path) else None
    return get


def _ts_zarr(root, name, arr, chunks, **meta):
    spec = {"driver": "zarr", "kvstore": f"file://{root}/{name}",
            "metadata": {"shape": list(arr.shape), "chunks": list(chunks),
                         "dtype": meta.pop("dtype", arr.dtype.str), **meta},
            "create": True}
    ts.open(spec).result()[...] = arr


@pytest.mark.parametrize("order", ["C", "F"])
@pytest.mark.parametrize("dtype", ["<f4", ">f4", "<f8", ">f8", "<i4", ">i4", "<i8", ">i8", "|b1"])
def test_zarr_dtypes_orders_and_edge_chunks(tmp_path, dtype, order):
    rng = np.random.default_rng(0)
    arr = (rng.normal(size=(5, 7, 3)) * 1000).astype(dtype)
    if dtype == "|b1":
        arr = rng.random((5, 7, 3)) < 0.5
    _ts_zarr(tmp_path, "a", arr, (2, 3, 3), order=order,
             compressor={"id": "zstd", "level": 5})
    got = zarr.read_array(_file_get(tmp_path), "a")
    assert got.dtype == np.dtype(dtype).newbyteorder("=") and got.dtype.isnative
    np.testing.assert_array_equal(got, arr)


def test_zarr_separator_scalar_and_missing_chunks(tmp_path):
    arr = np.arange(24, dtype=np.float32).reshape(4, 6)
    _ts_zarr(tmp_path, "nested", arr, (3, 4), dimension_separator="/", compressor=None)
    assert os.path.isfile(tmp_path / "nested" / "1" / "1")
    np.testing.assert_array_equal(zarr.read_array(_file_get(tmp_path), "nested"), arr)
    _ts_zarr(tmp_path, "scalar", np.asarray(2 ** 40), (), compressor={"id": "zstd", "level": 1})
    got = zarr.read_array(_file_get(tmp_path), "scalar")
    assert got.shape == () and int(got) == 2 ** 40
    # a chunk never written reads as tensorstore reads it: zeros under a null fill value
    spec = {"driver": "zarr", "kvstore": f"file://{tmp_path}/sparse",
            "metadata": {"shape": [4, 6], "chunks": [2, 3], "dtype": "<f4",
                         "fill_value": None, "compressor": None}, "create": True}
    sparse = ts.open(spec).result()
    sparse[0:2, 0:3] = np.ones((2, 3), np.float32)
    want = sparse.read().result()
    got = zarr.read_array(_file_get(tmp_path), "sparse")
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 6 and sorted(os.listdir(tmp_path / "sparse")) == [".zarray", "0.0"]


@pytest.mark.parametrize("change, match", [
    ({"dtype": "bfloat16"}, "dtype"),
    ({"dtype": "<u2"}, "dtype"),
    ({"filters": [{"id": "delta", "dtype": "<f4"}]}, "filters"),
    ({"compressor": {"id": "blosc"}}, "compressor"),
    ({"zarr_format": 3}, "zarr_format"),
])
def test_zarr_unsupported_metadata_raises(tmp_path, change, match):
    zarr.write_array(str(tmp_path), "a", np.ones(3, np.float32))
    meta_path = tmp_path / "a" / ".zarray"
    meta = json.loads(meta_path.read_text())
    meta.update(change)
    meta_path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match=match):
        zarr.read_array(_file_get(tmp_path), "a")


def test_zarr_writer_output_reads_in_tensorstore(tmp_path):
    arrays = {"f": np.arange(6, dtype=">f4").reshape(2, 3), "i": np.asarray(7, np.int64),
              "b": np.array([True, False])}
    for name, arr in arrays.items():
        zarr.write_array(str(tmp_path), name, arr)
        spec = {"driver": "zarr", "kvstore": f"file://{tmp_path}/{name}"}
        got = ts.open(spec).result().read().result()
        np.testing.assert_array_equal(got, arr)
        meta = json.loads((tmp_path / name / ".zarray").read_text())
        assert meta["compressor"] is None and meta["order"] == "C"
        assert meta["dtype"] == np.dtype(arr.dtype).newbyteorder("<").str
