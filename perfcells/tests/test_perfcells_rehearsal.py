"""Each cell rehearses on the CPU at a tiny size through the harness's own
functions: the result line has the contract's keys, the check passes, the
traced run reads its per-layer metrics, and no JAX module is loaded."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import perfcells_tiny as tiny
from perfcells import harness

CELLS = sorted(tiny.TINY)
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_rehearses_and_passes_its_check(cell, capsys):
    result, checks = tiny.run(cell)
    assert result["correct"] is True, checks.line()
    assert set(result["metrics"]) == set(harness.load_cell(cell)["cell"]["end_to_end"])
    assert result["attempted"] > 0 and result["failed"] == 0
    harness.emit(result, checks)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == KEYS and list(line)[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert harness.forbidden_modules() == []


@pytest.mark.parametrize("cell", CELLS)
def test_traced_rehearsal_reads_the_host_side_metrics(cell):
    result, _ = tiny.run(cell, trace=True)
    assert set(result) == KEYS - {"checks"} | {"breakdown"}
    assert {"busy_s", "window_s"} <= set(result["device"])
    spec = harness.load_cell(cell)["cell"]
    assert set(result["metrics"]) <= set(spec["per_layer"])
    assert any(k.startswith("mfu_pct") for k in result["metrics"])


def test_run_refuses_without_a_card(tmp_path):
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, os.path.join(harness.HERE, "run.py"), "--workload",
                        "c4-serve-poisson", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=harness.ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_refuses_without_the_program(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "perfcells",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run([sys.executable, "perfcells/run.py", "--workload", "c3-population-train",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_float64_witness_reads_both_sides(capsys):
    """``hooks.witness=float64`` prints, lane by lane, how far the program
    and the float32 reference each lie from the reference in double
    precision; the check itself is unchanged."""
    result, _ = tiny.run("c3-population-train", **{"hooks.witness": "float64"})
    assert result["correct"] is True
    lines = [json.loads(x) for x in capsys.readouterr().err.splitlines()
             if x.startswith('{"witness_float64"')]
    assert [x["witness_float64"] for x in lines] == ["program", "reference"]
    lanes = tiny.TRAIN["config.population"]
    for x in lines:
        assert len(x["mu1"]) == len(x["change"]) == lanes and len(x["loss"]) == 3
        assert all(gap < 1e-3 for gap, _, _ in x["mu1"])


def test_a_stopped_trace_covers_only_its_window():
    """``Capture.stop()`` closes the traced window; what runs after it is
    left out of the trace."""
    import time

    import torch

    from perfcells import trace

    with trace.traced(True) as cap:
        torch.ones(4).add_(1)
        time.sleep(0.05)
        cap.stop()
        cap.stop()
        time.sleep(0.3)
    assert cap.summary is not None and cap.summary["window_s"] < 0.25
