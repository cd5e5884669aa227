"""The dense-rung sweep report of the port (``experiments/torch_dense_sweep_report.py``)
against the JAX script (``experiments/dense_sweep_report.py``) on the CPU:
the control, cell A (hidden 32 stands for 128: a width other than the
control's) and cell B (``--gat-layers 2``), tiny trees trained by the port's
CLI on a 30-frame synthetic tree; cells C-E absent, so both print their
"(missing: ...)" rows.  Cells C-E are ``test_torch_experiments_dense_cells.py``'s:
a file of their own, so that the JAX script's compilations (two a cell) spread
over two workers.
"""

import pytest
import torch

from torch_experiments import check_dense_report, dense_trees, numpy_parser

torch.set_num_threads(2)
__all__ = ["numpy_parser"]  # the fixture, used by name

CELLS = ("control", "A", "B")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("dense")
    dense_trees(root, CELLS, 30)
    return root


def test_tables_match_the_jax_script(trees, numpy_parser, monkeypatch, capsys):
    tables = check_dense_report(trees, CELLS, monkeypatch, capsys)
    rows = tables["plain"]["os6"]
    assert rows["gat_layers=2"]["route"] == "plain"
    assert rows["hidden=128 4h (hd32)"]["min_ade"][1] > 0  # three seeds, a spread
