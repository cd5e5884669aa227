"""The port's profiling and debug hooks (``mmtraj_torch/utils/profiling.py``),
its TensorBoard mirror (``MetricsLogger(tensorboard=True)``) and
``cli train --profile/--debug-nans/--tensorboard`` with ``cli
profile-stats``, on the CPU (counterpart of ``tests/test_profiling.py``).

A CPU trace holds no device events, so the device totals are checked on a
trace file written by hand in the Chrome format the profiler exports."""

import glob
import json
import sys

import numpy as np
import pytest
import torch

from mmtraj_torch import cli
from mmtraj_torch.utils import profiling
from mmtraj_torch.utils.logging import MetricsLogger
from mmtraj_torch.utils.profiling import (annotate, assert_finite_tree, print_trace_summary,
                                          summarize_trace, trace_ctx)
from torch_jax_streams import write_scenes

torch.set_num_threads(2)


@pytest.fixture
def nan_debugging():
    profiling.enable_nan_debugging()
    try:
        yield
    finally:
        profiling.disable_nan_debugging()


def test_trace_ctx_writes_a_trace_that_summarizes(tmp_path, capsys):
    with trace_ctx(str(tmp_path), enabled=True):
        with annotate("test-region"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    traces = glob.glob(str(tmp_path / "profile" / "*.pt.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.load(open(traces[0]))["traceEvents"]}
    assert "test-region" in names and "aten::mm" in names
    assert summarize_trace(str(tmp_path / "profile")) == ({}, [])  # no card, no device events
    print_trace_summary(str(tmp_path / "profile"))
    assert "no device events" in capsys.readouterr().out


def test_summarize_trace_totals_device_events_only(tmp_path, capsys):
    events = [
        {"ph": "X", "cat": "kernel", "name": "gat_kernel", "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "gat_kernel", "dur": 12.0},
        {"ph": "X", "cat": "kernel", "name": "decode_kernel", "dur": 100.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 3.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "dur": 1.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 5000.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "dur": 400.0},
        {"ph": "i", "cat": "kernel", "name": "marker"},
    ]
    (tmp_path / "old.pt.trace.json").write_text(json.dumps({"traceEvents": []}))
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "new.pt.trace.json").write_text(json.dumps({"traceEvents": events}))
    by_cat, rows = summarize_trace(str(tmp_path), top=2)
    assert by_cat == {"kernel": 122.0, "gpu_memcpy": 3.0, "gpu_memset": 1.0}
    assert list(by_cat) == ["kernel", "gpu_memcpy", "gpu_memset"]
    assert rows == [(100.0, "kernel", "decode_kernel", 1), (22.0, "kernel", "gat_kernel", 2)]
    print_trace_summary(str(tmp_path), top=2)
    out = capsys.readouterr().out
    assert "device time by category (126 us total)" in out and "x2" in out
    assert "aten::mm" not in out


def test_trace_ctx_disabled_writes_nothing(tmp_path):
    for out, enabled in ((str(tmp_path / "run"), False), (None, True)):
        with trace_ctx(out, enabled=enabled):
            torch.ones(4).sum()
    assert not (tmp_path / "run").exists()


def test_summarize_missing_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="pt.trace.json"):
        summarize_trace(str(tmp_path))


def test_forward_nan_raises(nan_debugging):
    x = torch.tensor([0.0, 1.0])
    with pytest.raises(FloatingPointError, match="div"):
        x / x
    assert torch.isfinite(x + 1).all()


def test_backward_nan_raises(nan_debugging):
    w = torch.tensor([0.0, 1.0], requires_grad=True)
    y = (torch.sqrt(w) * 0.0).sum()  # finite forward; 0 * inf in the backward
    assert y.item() == 0.0
    with pytest.raises(FloatingPointError, match="NaN"):
        y.backward()


def test_nan_check_skips_views_and_unwritten_memory():
    """A view makes no value, and a buffer from ``empty`` holds whatever bits
    were there until it is filled; neither is checked, what computes is."""
    x = torch.tensor([float("nan"), 1.0])
    profiling.enable_nan_debugging()
    try:
        x[0], x.view(2, 1), x[1:]
        buf = torch.empty(4096)
        buf[:2048].uniform_()
        buf[2048:].normal_()
        assert torch.isfinite(buf).all()
        with pytest.raises(FloatingPointError, match="add"):
            x + 1.0
    finally:
        profiling.disable_nan_debugging()


def test_nan_debugging_switches_off():
    profiling.enable_nan_debugging()
    assert profiling.nan_debugging()
    profiling.disable_nan_debugging()
    assert not profiling.nan_debugging()
    x = torch.tensor([0.0])
    assert torch.isnan(x / x).all()


def test_assert_finite_tree_names_label_and_leaf():
    assert_finite_tree({"a": torch.ones(3), "b": {"c": np.zeros(2)}, "d": [1.0, torch.zeros(1)]})
    with pytest.raises(AssertionError, match=r"grads: leaf dense/w has 1 of 2"):
        assert_finite_tree({"dense": {"w": torch.tensor([1.0, float("nan")])}}, label="grads")
    with pytest.raises(AssertionError, match=r"leaf 1/0"):
        assert_finite_tree([np.ones(2), [np.array([np.inf])]])


def test_metrics_logger_tensorboard(tmp_path):
    lg = MetricsLogger(str(tmp_path), quiet=True, tensorboard=True)
    lg.log(1, loss=0.5)
    lg.log(2, loss=0.25, event="checkpoint")  # non-float values are not mirrored
    lg.close()
    assert glob.glob(str(tmp_path / "tb" / "events.out.tfevents.*"))
    recs = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert recs[0]["loss"] == 0.5 and recs[1]["event"] == "checkpoint"


def test_metrics_logger_without_tensorboard_goes_on(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # import raises
    lg = MetricsLogger(str(tmp_path), quiet=True, tensorboard=True)
    lg.log(1, loss=0.5, per_k=np.array([0.5, 0.75]))
    lg.close()
    assert "continuing with JSONL only" in capsys.readouterr().out
    assert not (tmp_path / "tb").exists()
    rec = json.loads(open(tmp_path / "metrics.jsonl").read())
    assert rec["loss"] == 0.5 and rec["per_k"] == [0.5, 0.75]


def _losses(out_dir):
    return [r["loss"] for r in map(json.loads, open(out_dir / "metrics.jsonl")) if "loss" in r]


def test_cli_train_profile_tensorboard_debug_nans(tmp_path, capsys):
    data = write_scenes(tmp_path)
    argv = ["train", "--config", "4", "--data-dir", data, "--scene", "zara1", "--steps", "4",
            "--batch-size", "2", "--hidden-dim", "16", "--k", "2", "--n-max", "8",
            "--obs-len", "4", "--pred-len", "3", "--steps-per-dispatch", "2", "--device", "cpu"]
    assert cli.main(argv + ["--out-dir", str(tmp_path / "a"), "--profile", "--tensorboard"]) == 0
    assert glob.glob(str(tmp_path / "a" / "tb" / "events.out.tfevents.*"))
    capsys.readouterr()
    assert cli.main(["profile-stats", "--trace-dir", str(tmp_path / "a" / "profile")]) == 0
    assert "no device events" in capsys.readouterr().out
    try:
        assert cli.main(argv + ["--out-dir", str(tmp_path / "b"), "--debug-nans"]) == 0
        assert profiling.nan_debugging()
    finally:
        profiling.disable_nan_debugging()
    assert _losses(tmp_path / "b") == _losses(tmp_path / "a") and _losses(tmp_path / "a")
