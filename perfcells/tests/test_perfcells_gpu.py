"""On the card, at each cell's own sizes with a short window: a run passes
its check, and the control (the reference in real TF32 in the program's
place) fails it."""

import time

import pytest

from perfcells import harness
from perfcells.run import run_cell

SECONDS = {"c3-population-train": 0.01, "c4-serve-poisson": 2.0}


def _run(cell, seed, **over):
    spec = harness.load_cell(cell, over)
    return run_cell(spec, seed, SECONDS[cell], False, "cuda", time.perf_counter())


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(SECONDS))
def test_cell_on_the_card(cell, cuda_device):
    result, checks = _run(cell, 2**31 + 101)
    assert result["correct"] is True, checks.line()
    assert result["device"]["platform"] == "gpu"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(SECONDS))
def test_tf32_control_on_the_card(cell, cuda_device):
    result, checks = _run(cell, 2**31 + 102, **{"hooks.control": "tf32"})
    assert result["correct"] is False, checks.line()
