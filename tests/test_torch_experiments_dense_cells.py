"""The dense-rung sweep report of the port against the JAX script on the CPU
(as ``test_torch_experiments_dense.py``), for cells C and D (radius 2 and 8)
and cell E (``--n-max 128``, seed 0 only: the flat single-seed tree), the
control and cells A and B absent."""

import pytest
import torch

from torch_experiments import check_dense_report, dense_trees, numpy_parser

torch.set_num_threads(2)
__all__ = ["numpy_parser"]  # the fixture, used by name

CELLS = ("C", "D", "E")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("dense_cells")
    dense_trees(root, CELLS, 30)
    return root


def test_tables_match_the_jax_script(trees, numpy_parser, monkeypatch, capsys):
    tables = check_dense_report(trees, CELLS, monkeypatch, capsys)
    rows = tables["plain"]["iid"]
    assert (trees / "runs/r5/dense_n128/checkpoint_ema.npz").exists()
    assert rows["n_max=128"]["min_ade"][1] == 0.0  # one seed, no spread
