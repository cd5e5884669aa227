"""The per-layer metrics that read the program's spans
(``perfcells/spans.py`` and its readers in ``metrics/``): each on a span
list made by hand, None where the program kept none or has no spans at
all, and each read from a traced run of its cell on the CPU (given as the
cell's ``per_layer`` by ``--set``'s override)."""

import math
from types import SimpleNamespace

import pytest

import perfcells_tiny as tiny
from perfcells import harness

MS = 1_000_000
SERVE = ("serve.parse_ms", "serve.dispatch_ms", "serve.encode_ms", "serve.loop_busy_pct",
         "serve.loop_offcpu_pct")
TRAIN = ("train.enqueue_ms", "train.chunk_head_ms")


def _span(name, thread, a, b, cpu=None, parent=None, outlived=False, **ids):
    return SimpleNamespace(name=name, thread=thread, start_ns=int(a * MS),
                           end_ns=None if b is None else int(b * MS),
                           cpu_ns=int((b - a if cpu is None else cpu) * MS) if b else None,
                           parent=parent, ids=ids, outlived=outlived)


LOOP, WRITER = 1, 2
SERVE_SPANS = [
    _span("serve.input_wait", LOOP, 0, 1, cpu=0),
    _span("serve.parse", LOOP, 1, 3, cpu=1.5, request=0),
    _span("serve.parse", LOOP, 3, 4, request=1),
    _span("serve.flush", LOOP, 4, 10, cpu=4, call=0),
    _span("serve.dispatch", LOOP, 4, 7, parent=3, call=0, windows=2),
    _span("serve.emit_wait", LOOP, 7, 8, cpu=0, parent=3, call=0, request=0),
    _span("serve.emit_wait", LOOP, 8, 9, cpu=0, parent=3, call=0, request=1),
    _span("serve.fetch", WRITER, 7, 9, call=0),
    _span("serve.encode", WRITER, 9, 10, request=0),
    _span("serve.write", WRITER, 10, 10.5, request=0),
    _span("serve.encode", WRITER, 10.5, 11, request=1),
    _span("serve.write", WRITER, 11, 12, request=1),
    _span("serve.parse", LOOP, 11, 12, request=2),
    _span("serve.emit_wait", LOOP, 12, 13, cpu=0, request=2),  # an error line's, on its own
    _span("serve.write", WRITER, 12, 12.5, request=2),
    _span("serve.flush", LOOP, 13, 40, outlived=True, call=1),  # past the window: not read
    _span("serve.emit_wait", LOOP, 14, 15, cpu=0, parent=15, call=1, request=3),
    _span("serve.encode", WRITER, 12.5, 30, request=3),  # ends while the profiler stops
    _span("serve.encode", WRITER, 30, 31, outlived=True, request=4),
    _span("serve.flush", LOOP, 16, None, call=2),  # still open: not read
]
TRAIN_SPANS = [
    _span("train.chunk", LOOP, 0, 100),
    _span("train.upload", LOOP, 0, 5, parent=0),
    _span("train.step", LOOP, 5, 20, parent=0, step=3),
    _span("train.draw", LOOP, 5, 12, parent=2, step=3),
    _span("train.replay", LOOP, 12, 18, parent=2, step=3),
    _span("train.step", LOOP, 20, 30, parent=0, step=4),
    _span("train.draw", LOOP, 20, 25, parent=5, step=4),
    _span("train.replay", LOOP, 25, 29, parent=5, step=4),
]
WANT = {
    "serve.parse_ms": (2 + 1 + 1) / 3,
    "serve.dispatch_ms": 3.0,
    "serve.encode_ms": (1 + 0.5 + 0.5 + 1 + 0.5) / 3,
    # parse 4 ms, flush 6 ms, less the 2 ms of emit_wait under the flush, over 20 ms
    "serve.loop_busy_pct": 100 * 8 / 20,
    # CPU: parse 1.5 + 1 + 1, flush 4: 7.5 of the 8 ms
    "serve.loop_offcpu_pct": 100 * 0.5 / 8,
    "train.enqueue_ms": (15 + 10) / 2,
    "train.chunk_head_ms": 18.0,
}


@pytest.fixture
def kept(monkeypatch):
    from mmtraj_torch.utils import profiling

    box = []
    monkeypatch.setattr(profiling, "spans", lambda: list(box))
    return box


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_reader_on_hand_made_spans(name, kept):
    kept.extend(SERVE_SPANS if name.startswith("serve") else TRAIN_SPANS)
    got = harness.metric_reader(name).read({"trace": {"window_s": 0.020}})
    assert got == pytest.approx(WANT[name], rel=1e-9)


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_reader_is_none_without_spans(name, kept, monkeypatch):
    reader = harness.metric_reader(name)
    assert reader.UNIT in ("ms", "%")
    assert reader.read({"trace": {"window_s": 1.0}}) is None
    kept.extend(TRAIN_SPANS if name.startswith("serve") else SERVE_SPANS)  # the other cell's
    assert reader.read({"trace": {"window_s": 1.0}}) is None
    from mmtraj_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")  # a program that keeps no spans
    assert reader.read({"trace": {"window_s": 1.0}}) is None


@pytest.mark.parametrize("cell, names", [("c4-serve-poisson", SERVE),
                                         ("c3-population-train", TRAIN[:1])])
def test_traced_rehearsal_reads_the_span_metrics(cell, names, monkeypatch):
    """A traced run of the cell on the CPU, the new readers named as its
    per-layer metrics: each finite.  The serve window is long and its load
    light, so that responses are mostly written inside it; on a slow host the
    writer may finish none before the window closes, and then
    ``serve.encode_ms`` has nothing to read.  (``train.chunk_head_ms`` needs
    a graphed chunk, which the CPU runs eagerly.)"""
    from mmtraj_torch.utils import profiling
    from perfcells import spans as sp

    per_layer = harness.load_cell(cell)["cell"]["per_layer"] + list(names)
    extra = {"cell.per_layer": per_layer}
    if cell.startswith("c4"):
        monkeypatch.setitem(tiny.SECONDS, cell, 2.0)
        extra["traffic.arrivals.rate_per_s"] = 10
    profiling.clear_spans()
    try:
        result, _ = tiny.run(cell, trace=True, **extra)
        kept = profiling.spans()
    finally:
        profiling.clear_spans()
    if not any(True for _ in sp.closed(kept, "serve.write")):
        names = [n for n in names if n != "serve.encode_ms"]
    for name in names:
        assert math.isfinite(result["metrics"][name]["value"]), name
    if cell.startswith("c4"):
        assert 0 < result["metrics"]["serve.loop_busy_pct"]["value"] <= 100
        assert 0 <= result["metrics"]["serve.loop_offcpu_pct"]["value"] <= 100
