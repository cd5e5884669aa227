"""The port's profiling and debug hooks (``mmtraj_torch/utils/profiling.py``),
its TensorBoard mirror (``MetricsLogger(tensorboard=True)``) and
``cli train --profile/--debug-nans/--tensorboard`` with ``cli
profile-stats``, on the CPU (counterpart of ``tests/test_profiling.py``).

A CPU trace holds no device events, so the device totals are checked on a
trace file written by hand in the Chrome format the profiler exports."""

import glob
import json
import sys
import time

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


def test_annotate_is_a_shared_no_op_without_a_profiler(monkeypatch):
    """With no profiler running a span is one flag read: the same object
    every time, nothing kept, and no profiler event opened (neither
    ``record_function`` nor its C++ form called)."""

    def refuse(*a, **k):
        raise AssertionError("record_function called with no profiler running")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    profiling.clear_spans()
    first = annotate("serve.parse", request=3)
    assert annotate("train.step", step=1) is first and annotate("x") is first
    with annotate("serve.flush", call=0):
        with annotate("serve.dispatch", windows=8):
            torch.ones(4).sum()
    assert profiling.spans() == []


def _traced(fn, tmp_path):
    """Run ``fn`` under a CPU profiler -> (the trace's events, its header's
    ``baseTimeNanoseconds``)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = str(tmp_path / "spans.pt.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        trace = json.load(fh)
    return trace["traceEvents"], int(trace["baseTimeNanoseconds"])


def test_spans_keep_parents_ids_threads_and_outlive_the_profiler(tmp_path):
    import threading

    profiling.clear_spans()
    box = {}

    def work():
        with annotate("writer", call=2):
            with annotate("writer.inner", request=5):
                time.sleep(0.002)
        box["thread"] = threading.get_ident()

    def fn():
        with annotate("outer", call=1):
            with annotate("inner", request=4):
                now = profiling.spans()[-1]  # an open span: no end yet
                assert now.name == "inner" and now.end_ns is None and now.cpu_ns is None
                t = threading.Thread(target=work)
                t.start()
                t.join()
            with annotate("inner2", call=3):
                pass
        box["late"] = annotate("late", call=9)
        box["late"].__enter__()

    events, _ = _traced(fn, tmp_path)
    box["late"].__exit__(None, None, None)  # the profiler has stopped: kept, no error
    got = {s.name: (i, s) for i, s in enumerate(profiling.spans())}
    assert set(got) == {"outer", "inner", "inner2", "writer", "writer.inner", "late"}
    outer, inner, inner2 = got["outer"][1], got["inner"][1], got["inner2"][1]
    writer, winner, late_s = got["writer"][1], got["writer.inner"][1], got["late"][1]
    assert outer.parent is None and outer.ids == {"call": 1}
    assert inner.parent == got["outer"][0] and inner.ids == {"call": 1, "request": 4}
    assert inner2.parent == got["outer"][0] and inner2.ids == {"call": 3}
    assert writer.parent is None and winner.parent == got["writer"][0]
    assert winner.ids == {"call": 2, "request": 5}
    assert writer.thread == box["thread"] != outer.thread
    assert late_s.end_ns is not None and late_s.parent is None and late_s.outlived
    assert [s.name for s in profiling.spans() if s.outlived] == ["late"]
    for s in profiling.spans():
        assert s.start_ns <= s.end_ns and 0 <= s.cpu_ns
    assert inner.start_ns <= writer.start_ns <= winner.end_ns <= inner.end_ns
    assert winner.end_ns - winner.start_ns >= 2_000_000 > winner.cpu_ns  # asleep, off the CPU
    names = {e.get("name") for e in events if e.get("cat") == "cpu_op"}
    assert {"outer", "inner", "inner2"} <= names and "writer" not in names  # other threads' drop
    profiling.clear_spans()
    assert profiling.spans() == []


def test_spans_from_many_threads_keep_every_span_and_parent():
    """Threads (more than cores) opening nested spans at once, with a short
    switch interval: every span kept once, each child's parent its own
    thread's enclosing span."""
    import os
    import threading

    from torch.profiler import ProfilerActivity, profile

    n_threads, n_spans = 2 * (os.cpu_count() or 2) + 2, 50
    profiling.clear_spans()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            def work(t):
                for i in range(n_spans):
                    with annotate("outer", call=t):
                        with annotate("inner", step=i):
                            pass

            threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    spans = profiling.spans()
    profiling.clear_spans()
    assert len(spans) == 2 * n_threads * n_spans
    inner = [s for s in spans if s.name == "inner"]
    for s in inner:
        p = spans[s.parent]
        assert p.name == "outer" and p.thread == s.thread and p.ids["call"] == s.ids["call"]
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    pairs = {(s.ids["call"], s.ids["step"]) for s in inner}
    assert len(pairs) == n_threads * n_spans


def test_kept_spans_give_the_collector_nothing_to_walk():
    """A traced window keeps tens of thousands of spans; a full collection
    that walked them all would stall the program, so a closed span is kept
    in a form the collector stops tracking."""
    import gc

    from torch.profiler import ProfilerActivity, profile

    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with annotate("warm", call=0):
            pass
        gc.collect()
        tracked = len(gc.get_objects())
        for i in range(2000):
            with annotate("outer", call=i):
                with annotate("inner", request=i):
                    pass
        gc.collect()
        added = len(gc.get_objects()) - tracked
    assert len(profiling.spans()) == 4001 and added < 100, added
    profiling.clear_spans()


def test_span_start_is_on_the_device_traces_clock(tmp_path):
    """A span's ``start_ns`` (wall clock) lies within 1 ms of its Kineto
    event's ``ts * 1000 + baseTimeNanoseconds``."""
    profiling.clear_spans()

    def fn():
        for i in range(5):
            with annotate("clock", step=i):
                time.sleep(0.003)

    events, base = _traced(fn, tmp_path)
    kineto = sorted(float(e["ts"]) * 1000 + base for e in events
                    if e.get("name") == "clock" and e.get("cat") == "cpu_op")
    mine = [s.start_ns for s in profiling.spans() if s.name == "clock"]
    assert len(kineto) == len(mine) == 5
    assert max(abs(a - b) for a, b in zip(kineto, mine)) < 1e6
    profiling.clear_spans()


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
