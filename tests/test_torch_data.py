"""The port's host data path against the JAX package's numpy modules: the
annotation parser, windowing, padding, the window set and the norm stats,
all exactly equal; the scene registry's errors.  The JAX side here is its
numpy parser (``mmtraj.data.parser``), never the native one."""

import os

import numpy as np
import pytest

from mmtraj.data.collate import WindowDataset as JWindowDataset
from mmtraj.data.collate import pad_windows as j_pad_windows
from mmtraj.data.parser import read_annotation_file as j_read_annotation_file
from mmtraj.data.parser import scene_arrays as j_scene_arrays
from mmtraj.data.transforms import compute_norm_stats as j_compute_norm_stats
from mmtraj.data.windower import make_windows as j_make_windows
from mmtraj_torch.config import SCENES
from mmtraj_torch.data.collate import WindowDataset, pad_windows
from mmtraj_torch.data.parser import read_annotation_file, scene_arrays
from mmtraj_torch.data.registry import leave_one_out, load_scene_windows, load_split, scene_files
from mmtraj_torch.data.transforms import compute_norm_stats
from mmtraj_torch.data.windower import make_windows

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
                    "synthetic3000")
MESSY = """# frame ped x y
10\t1\t1.5\t2.5

10 2 -3.25 4.0 extra columns here
% a comment
20,1,1.75,2.25
20  2  -3.0  4.5junk
30\t1\t2.0\t2.0\t0.0
+40 1 .5 1e1
"""


@pytest.fixture(scope="module")
def eth_rows():
    return read_annotation_file(f"{DATA}/eth.txt")


def test_parser_matches_jax_on_a_messy_file(tmp_path):
    path = tmp_path / "messy.txt"
    path.write_text(MESSY)
    got = read_annotation_file(str(path))
    np.testing.assert_array_equal(got, j_read_annotation_file(str(path)))
    assert got.shape == (6, 4) and got.dtype == np.float64


def test_parser_matches_jax_on_a_scene(eth_rows):
    np.testing.assert_array_equal(eth_rows, j_read_annotation_file(f"{DATA}/eth.txt"))
    assert eth_rows.shape[1] == 4 and len(eth_rows) > 1000


@pytest.mark.parametrize("text, shape", [("", (0, 4)), ("# only a comment\n", (0, 4))])
def test_parser_empty_files(text, shape, tmp_path):
    path = tmp_path / "empty.txt"
    path.write_text(text)
    assert read_annotation_file(str(path)).shape == shape
    assert j_read_annotation_file(str(path)).shape == shape


def test_parser_malformed_line_raises_as_jax(tmp_path):
    path = tmp_path / "bad.txt"
    path.write_text("10 1 1.0 2.0\n20 1 oops 2.0\n")
    with pytest.raises(ValueError) as want:
        j_read_annotation_file(str(path))
    with pytest.raises(ValueError, match="malformed line 2") as got:
        read_annotation_file(str(path))
    assert str(got.value) == str(want.value)


def test_scene_arrays_match_jax(eth_rows):
    for got, want in zip(scene_arrays(eth_rows), j_scene_arrays(eth_rows)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


@pytest.mark.parametrize("obs, pred, stride, min_agents", [
    (8, 12, 1, 1), (8, 12, 3, 1), (8, 12, 1, 4), (4, 3, 2, 2),
])
def test_make_windows_matches_jax(obs, pred, stride, min_agents, eth_rows):
    got = make_windows(eth_rows, obs, pred, stride, min_agents)
    want = j_make_windows(eth_rows, obs, pred, stride, min_agents)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.float32 and a.shape[0] >= min_agents


@pytest.mark.parametrize("n_max", [3, 8, 64])
def test_pad_windows_and_dataset_match_jax(n_max):
    """Windows over n_max keep the agents nearest their centroid; the
    overflow count and the padded arrays are JAX's."""
    rng = np.random.default_rng(0)
    windows = [rng.normal(size=(n, 20, 2)).astype(np.float32) * 3 for n in (1, 5, 9, 2, 12)]
    got, want = pad_windows(windows, n_max), j_pad_windows(windows, n_max)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[2] == sum(max(0, n - n_max) for n in (1, 5, 9, 2, 12))
    ds, jds = WindowDataset(windows, n_max), JWindowDataset(windows, n_max)
    assert (len(ds), ds.n_max, ds.seq_len, ds.n_dropped) == (len(jds), jds.n_max, jds.seq_len,
                                                               jds.n_dropped)
    idx = np.array([4, 0, 2])
    for a, b in zip(ds.batch(idx), jds.batch(idx)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ds.epoch_batches(2, np.random.default_rng(1)),
                    jds.epoch_batches(2, np.random.default_rng(1))):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_pad_windows_rejects_an_empty_list():
    with pytest.raises(ValueError, match="no windows"):
        pad_windows([], 8)


@pytest.mark.parametrize("which", ["scene", "empty", "still"])
def test_compute_norm_stats_matches_jax(which, eth_rows):
    if which == "scene":
        windows = j_make_windows(eth_rows, 8, 12)
    elif which == "empty":
        windows = [np.zeros((0, 20, 2), np.float32)]
    else:  # agents that never move: a std of 0 becomes 1
        windows = [np.ones((3, 20, 2), np.float32)]
    got, want = compute_norm_stats(windows, 8), j_compute_norm_stats(windows, 8)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.float32


def test_load_split_holds_out_univ():
    """The evaluator's held-out scene on the in-repo data: 2,981 windows of
    at most 57 agents, the same windows as JAX's numpy path."""
    train, test = load_split(DATA, "univ", 8, 12)
    assert len(test) == 2981 and max(w.shape[0] for w in test) == 57
    want = j_make_windows(j_read_annotation_file(f"{DATA}/univ.txt"), 8, 12)
    assert all(np.array_equal(a, b) for a, b in zip(test, want))
    assert len(train) == sum(len(load_scene_windows(DATA, s, 8, 12)) for s in SCENES
                             if s != "univ")


def test_registry_errors(tmp_path):
    with pytest.raises(KeyError, match="unknown scene"):
        leave_one_out("atlantis")
    assert leave_one_out("eth") == (["hotel", "univ", "zara1", "zara2"], ["eth"])
    with pytest.raises(FileNotFoundError, match="no annotation files"):
        scene_files(str(tmp_path / "missing"), "eth")
    (tmp_path / "eth").mkdir()
    (tmp_path / "eth" / "b.txt").write_text("1 1 0 0\n")
    (tmp_path / "eth" / "a.txt").write_text("1 1 0 0\n")
    (tmp_path / "eth.txt").write_text("1 1 0 0\n")
    assert [os.path.basename(f) for f in scene_files(str(tmp_path), "eth")] == [
        "eth.txt", "a.txt", "b.txt"]
