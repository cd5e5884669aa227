"""The port's read-only OCDBT store (``mmtraj_torch/orbax_io/ocdbt.py``)
against stores that tensorstore writes.

Each store is written by tensorstore's ``ocdbt`` key-value store under one config
(compression none or zstd; values inline or all in data files; nodes small
enough that 2,000 keys need interior nodes; 24 commits into a version tree
of arity 2; a numbered manifest), with keys that share prefixes, binary
keys, an overwritten and a deleted key.  The port must list the same keys
and read the same values as tensorstore.  A flipped byte in a node fails its
CRC-32C and raises ``ValueError`` naming the file.
"""

import os

import numpy as np
import pytest
import tensorstore as ts

from mmtraj_torch.orbax_io.crc32c import crc32c, verify_footer
from mmtraj_torch.orbax_io.ocdbt import OcdbtReader


def _batches(n_keys: int, commits: int):
    """``commits`` transactions of writes and, in the last, one overwrite and
    one delete."""
    rng = np.random.default_rng(n_keys)
    keys = [b"params.layer%02d.w/%d.%d" % (i % 17, i // 17, i % 3) for i in range(n_keys)]
    keys += [b"\x00\xff binary \x01", b"\xff\xfe", b"a", b"ab", b"abc"]
    items = [(k, rng.bytes(int(rng.integers(0, 300)))) for k in keys]
    batches = [[items[i] for i in part] for part in np.array_split(np.arange(len(items)), commits)]
    batches[-1] += [(b"ab", b"overwritten"), (b"a", None)]
    return batches


def _write(path, config, batches):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}", "config": config}).result()
    for batch in batches:
        with ts.Transaction() as txn:
            for k, v in batch:
                if v is None:
                    del kv.with_transaction(txn)[k]
                else:
                    kv.with_transaction(txn)[k] = v
    return kv


def _tensorstore_view(path):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}"}).result()
    return {k: kv.read(k).result().value for k in kv.list().result()}


CONFIGS = {
    "plain": ({}, 60, 1),
    "small_nodes": ({"max_decoded_node_bytes": 1024}, 2000, 1),
    "versions": ({"version_tree_arity_log2": 1}, 60, 24),
    "numbered": ({"manifest_kind": "numbered"}, 60, 3),
}
COMPRESSION = {"none": None, "zstd": {"id": "zstd", "level": 3}}


@pytest.mark.parametrize("inline", [0, 1 << 20])
@pytest.mark.parametrize("compression", sorted(COMPRESSION))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reads_what_tensorstore_wrote(tmp_path, name, compression, inline):
    extra, n_keys, commits = CONFIGS[name]
    config = {"compression": COMPRESSION[compression], "max_inline_value_bytes": inline, **extra}
    _write(tmp_path, config, _batches(n_keys, commits))
    want = _tensorstore_view(tmp_path)
    store = OcdbtReader(str(tmp_path))
    assert store.keys() == sorted(want)
    assert {k: store.read(k) for k in store.keys()} == want
    assert store.read(b"ab") == b"overwritten" and store.get(b"a") is None
    assert store.config.compression == (None if compression == "none" else ("zstd", 3))
    assert store.config.max_inline_value_bytes == inline
    assert [v.generation for v in store.versions][-1] == store.version.generation
    if name == "versions":  # every generation since the empty first, most in version nodes
        gens = [v.generation for v in store.versions]
        assert gens == list(range(1, len(gens) + 1)) and len(gens) > commits
    if name == "small_nodes":
        assert store.version.root_height >= 1
    if name == "numbered":
        assert store.config.manifest_kind == 1


def test_an_orbax_checkpoint_store_and_its_process_subdirectory():
    """The committed fixture: a merged top-level store whose root reaches the
    data files of ``ocdbt.process_0/``, and that per-process store itself."""
    root = os.path.join(os.path.dirname(__file__), "fixtures", "torch_orbax_c4")
    for path in (root, os.path.join(root, "ocdbt.process_0")):
        want = _tensorstore_view(path)
        store = OcdbtReader(path)
        assert store.keys() == sorted(want)
        assert all(store.read(k) == v for k, v in want.items())
    assert b"params.dec.gat.wv/0.0" in want and b"step/0" in want


def test_crc32c():
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(b"") == 0
    assert crc32c(b"56789", crc32c(b"1234")) == 0xE3069283


def test_a_flipped_node_byte_names_the_file(tmp_path):
    _write(tmp_path, {"compression": None, "max_inline_value_bytes": 1 << 20}, _batches(20, 1))
    (node,) = os.listdir(tmp_path / "d")
    path = tmp_path / "d" / node
    data = bytearray(path.read_bytes())
    verify_footer(bytes(data), str(path))
    data[20] ^= 0x10
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=f"{node}.*CRC-32C checksum mismatch"):
        OcdbtReader(str(tmp_path))


def test_a_truncated_manifest_raises(tmp_path):
    _write(tmp_path, {"compression": None}, _batches(5, 1))
    manifest = tmp_path / "manifest.ocdbt"
    manifest.write_bytes(manifest.read_bytes()[:-9])
    with pytest.raises(ValueError, match="manifest.ocdbt"):
        OcdbtReader(str(tmp_path))
