"""BIWI obsmat ingestion of the port (``mmtraj_torch/data/obsmat.py``) against
the JAX package's (``mmtraj/data/obsmat.py``): the same rows from the same
files, and converted files byte-equal."""

import numpy as np
import pytest

from mmtraj.data.obsmat import convert_obsmat as j_convert_obsmat
from mmtraj.data.obsmat import read_obsmat as j_read_obsmat
from mmtraj_torch.cli import main as cli_main
from mmtraj_torch.data.obsmat import convert_obsmat, read_obsmat
from mmtraj_torch.data.parser import read_annotation_file
from mmtraj_torch.data.windower import make_windows


def _obsmat_rows(rng, n=40):
    """8-column obsmat rows [frame id x z y vx vz vy], as tests/test_obsmat.py."""
    frames = np.repeat(np.arange(10, 10 + n // 4) * 6, 4).astype(np.float64)[:n]
    ids = np.tile(np.arange(1, 5), n // 4).astype(np.float64)[:n]
    x = rng.normal(size=n) * 3
    y = rng.normal(size=n) * 3
    z = rng.normal(size=n)  # the height axis, which must be dropped
    v = rng.normal(size=(n, 3))
    return np.column_stack([frames, ids, x, z, y, v])


@pytest.mark.parametrize("suffix", [".txt", ".mat"])
def test_read_obsmat_column_mapping_equals_jax(tmp_path, suffix):
    raw = _obsmat_rows(np.random.default_rng(0))
    p = tmp_path / f"obsmat{suffix}"
    if suffix == ".mat":
        from scipy.io import savemat

        savemat(str(p), {"obsmat": raw})
    else:
        np.savetxt(p, raw)
    out = read_obsmat(str(p))
    np.testing.assert_array_equal(out, raw[:, [0, 1, 2, 4]])  # pos_y, not the z column
    np.testing.assert_array_equal(out, j_read_obsmat(str(p)))


@pytest.mark.parametrize("suffix", [".txt", ".mat"])
def test_wrong_width_raises_as_jax(tmp_path, suffix):
    p = tmp_path / f"bad{suffix}"
    if suffix == ".mat":
        from scipy.io import savemat

        savemat(str(p), {"obsmat": np.zeros((5, 4))})
        match = "no 8-column obsmat matrix"
    else:
        np.savetxt(p, np.zeros((5, 4)))
        match = "8 obsmat columns"
    for read in (read_obsmat, j_read_obsmat):
        with pytest.raises(ValueError, match=match):
            read(str(p))


def test_convert_obsmat_byte_equal_to_jax_and_loads(tmp_path):
    """Converted files equal to the JAX package's byte for byte, and the
    port's own parser and windower take them (the real-data drop-in path)."""
    rng = np.random.default_rng(2)
    frames = np.repeat(np.arange(25) * 10, 2).astype(np.float64)
    x = np.linspace(0, 12, 50) + rng.normal(size=50) * 0.05
    y = np.linspace(0, 5, 50) + rng.normal(size=50) * 0.05
    raw = np.column_stack([frames, np.tile([1.0, 2.0], 25), x, np.zeros(50), y,
                           rng.normal(size=(50, 3))])
    src = tmp_path / "obsmat.txt"
    np.savetxt(src, raw)
    mine, theirs = tmp_path / "eth.txt", tmp_path / "eth_jax.txt"
    assert convert_obsmat(str(src), str(mine)) == j_convert_obsmat(str(src), str(theirs)) == 50
    assert mine.read_bytes() == theirs.read_bytes()
    windows = make_windows(read_annotation_file(str(mine)), obs_len=8, pred_len=12)
    assert windows and windows[0].shape == (2, 20, 2)


def test_cli_import_obsmat_prints_as_jax(tmp_path, capsys):
    from mmtraj.cli import main as j_cli_main

    src = tmp_path / "obsmat.txt"
    np.savetxt(src, _obsmat_rows(np.random.default_rng(3)))
    mine, theirs = tmp_path / "a.txt", tmp_path / "b.txt"
    assert cli_main(["import-obsmat", "--src", str(src), "--dst", str(mine)]) == 0
    out = capsys.readouterr().out
    assert j_cli_main(["import-obsmat", "--src", str(src), "--dst", str(theirs)]) == 0
    assert out.replace(str(mine), str(theirs)) == capsys.readouterr().out
    assert out == f"wrote 40 rows: {src} -> {mine}\n"
    assert mine.read_bytes() == theirs.read_bytes()
