"""Tracing, profiling and debug hooks (counterpart of
``mmtraj/utils/profiling.py``), over ``torch.profiler``.

``trace_ctx`` records the enclosed region, host and card, and writes a
Chrome trace (``*.pt.trace.json``) under ``{out_dir}/profile``;
``annotate`` opens a program span, recorded only while a profiler runs
(``spans()``, ``clear_spans()``); ``summarize_trace`` reads a trace
offline and totals its device events (``cli profile-stats``).  Debug aids:
``enable_nan_debugging`` raises on the first NaN that any op produces,
forward or backward (slow: every op's output is checked on the host), and
``assert_finite_tree`` checks every leaf of a dict or list of tensors and
arrays.
"""

from __future__ import annotations

import contextlib
import glob
import itertools
import json
import os
import socket
import threading
import time
from collections import defaultdict
from typing import Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
from torch._C import _profiler as _c_profiler
from torch.autograd import _profiler_enabled as _profiler_here
from torch.autograd import profiler as _autograd_profiler

# The trace's device events (Kineto's categories); every other event is the host's.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace_ctx(out_dir: Optional[str], enabled: bool = True) -> Iterator[None]:
    """Profile the enclosed region into ``{out_dir}/profile`` when enabled:
    CPU activity, and CUDA activity where there is a card."""
    if not (enabled and out_dir):
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    logdir = os.path.join(out_dir, "profile")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns() // 1_000_000}.pt.trace.json"
    prof.export_chrome_trace(os.path.join(logdir, name))


class Span(NamedTuple):
    """One program span, as ``spans()`` returns it: ``name``; ``thread``
    (``threading.get_ident()``); ``start_ns`` and ``end_ns`` on the wall
    clock (``time.time_ns()``; ``end_ns`` is None while the span is open);
    ``cpu_ns``, the thread's CPU time over the span (``time.thread_time_ns()``;
    None while open), so that wall less CPU is time off the CPU (waiting for
    the GIL, a lock, a blocking copy or the scheduler; where that clock
    ticks coarsely, every 10 ms on some hosts, only a sum over many spans
    says it); ``parent``, the index in ``spans()`` of the span open on the
    same thread when this one began, or None; ``ids``, its own keywords over
    its parent's; ``outlived``, whether the profiler stopped before the span
    closed (its end then lies past the traced window)."""

    name: str
    thread: int
    start_ns: int
    end_ns: Optional[int]
    cpu_ns: Optional[int]
    parent: Optional[int]
    ids: dict
    outlived: bool


class _Open:
    """A span while it is open: the context manager ``annotate`` returns."""

    __slots__ = ("name", "ids", "thread", "start_ns", "cpu_ns", "parent", "_kept", "_index",
                 "_rf")

    def __init__(self, name: str, ids: dict):
        self.name, self.ids = name, ids
        self.parent = None

    def __enter__(self) -> "_Open":
        # The wall clock is read and the profiler's event opened before the
        # rest, so that a span and its event cover the same time, its own
        # cost included (the thread's CPU clock can cost a system call).
        self.start_ns = time.time_ns()
        if _profiler_here():  # the profiler keeps events of its own thread only
            self._rf = _c_profiler._RecordFunctionFast(self.name)
            self._rf.__enter__()
        else:
            self._rf = None
        self.cpu_ns = time.thread_time_ns()
        stack = _stack()
        top = stack[-1] if stack else None
        kept = _kept
        if top is not None and top._kept is kept:
            self.parent = top._index
            self.ids = {**top.ids, **self.ids}
        self.thread = threading.get_ident()
        with _lock:
            self._index = len(kept)
            kept.append(self)
        self._kept = kept
        stack.append(self)
        return self

    def record(self) -> Span:
        return Span(self.name, self.thread, self.start_ns, None, None, self.parent, self.ids,
                    False)

    def __exit__(self, *exc) -> bool:
        cpu_ns = time.thread_time_ns() - self.cpu_ns
        _stack().pop()
        outlived = not _autograd_profiler._is_profiler_enabled
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        end_ns = time.time_ns()
        # Kept as one flat tuple of numbers and strings, which the garbage
        # collector stops tracking at its next pass: a traced window keeps
        # tens of thousands of spans, and a full collection that walked them
        # all would stall the traced program for tens of milliseconds.
        self._kept[self._index] = (self.name, self.thread, self.start_ns, end_ns, cpu_ns,
                                   self.parent, outlived, *itertools.chain(*self.ids.items()))
        return False


_OFF = contextlib.nullcontext()  # what ``annotate`` returns with no profiler running
_kept: list = []  # every span begun while a profiler ran, in the order begun
_lock = threading.Lock()
_local = threading.local()


def _stack() -> List[_Open]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def annotate(name: str, **ids):
    """A program span named ``name`` around the enclosed code, with ``ids``
    (``request=``, ``call=``, ``step=``, ``windows=``: whole numbers) that
    its children on the same thread inherit.

    On only while a torch profiler runs: ``torch.autograd.profiler.
    _is_profiler_enabled``, a module global that the profiler sets on
    starting and clears on stopping, so a span is on in every thread (the
    profiler's own ``torch.autograd._profiler_enabled()`` is per thread and
    reads False in a thread other than the one that started it).  The
    harness's traced window, ``trace_ctx`` (``cli train --profile``) and any
    ``torch.profiler.profile`` turn spans on.  Off, this is one read of that
    flag and returns one shared no-op context manager: nothing is allocated,
    recorded or handed to the profiler.

    On, the span is kept in memory (``spans()``, as a ``Span``) and, on the
    thread that started the profiler, opens a profiler event named ``name``
    (``torch._C._profiler._RecordFunctionFast``, the C++ form of
    ``torch.profiler.record_function`` that torch's compiled code uses; the
    event's category is ``cpu_op``).  The profiler keeps it beside the
    device's events, so a gap in the device's work falls under the program
    stage that was open.  ``record_function`` itself is not used: it calls a
    torch op, which releases the GIL at each edge of the span, where
    another Python thread (the serve loop's writer) takes it and the span's
    thread then waits outside any event; it also costs about ten times as
    much.  The profiler drops events from other threads (there
    ``torch.autograd._profiler_enabled()`` reads False and no event is
    opened).  Kineto's ``ts`` is microseconds after the trace's
    ``baseTimeNanoseconds``, so ``ts * 1000 + baseTimeNanoseconds`` lies
    just after the span's ``start_ns`` (the span covers its own entry; 0.02
    to 0.12 ms after it under torch 2.11 with CUDA on an H100's host): the
    in-memory spans of every thread share the trace's clock through that
    header.  A span still open when the profiler stops is kept and closes as
    usual, marked ``outlived``."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Open(name, ids)


def spans() -> List[Span]:
    """The spans begun while a profiler ran since the last ``clear_spans()``,
    in the order begun (open ones have ``end_ns`` None)."""
    return [x.record() if isinstance(x, _Open)
            else Span(*x[:6], dict(zip(x[7::2], x[8::2])), x[6]) for x in list(_kept)]


def clear_spans() -> None:
    """Forget every kept span; spans still open close without being kept
    again, and no later span names one of them as its parent."""
    global _kept
    with _lock:
        _kept = []


def _newest_trace(trace_dir: str) -> str:
    traces = glob.glob(os.path.join(trace_dir, "**", "*.pt.trace.json"), recursive=True)
    if not traces:
        raise FileNotFoundError(f"no *.pt.trace.json under {trace_dir!r}")
    return max(traces, key=os.path.getmtime)


def summarize_trace(trace_dir: str, top: int = 15):
    """Read the newest ``*.pt.trace.json`` under ``trace_dir`` (as written by
    ``trace_ctx`` or ``cli train --profile``) and total its device events ->
    ``(by_category, top_rows)``: microseconds by category (``kernel``,
    ``gpu_memcpy``, ``gpu_memset``), and the ``top`` events by their summed
    time as ``(time_us, category, name, occurrences)``.  A trace recorded
    without a card holds no device events: both come back empty.  Host
    (CPU op) times are never counted."""
    with open(_newest_trace(trace_dir)) as fh:
        events = json.load(fh).get("traceEvents", [])
    totals = defaultdict(float)
    counts = defaultdict(int)
    for e in events:
        cat = e.get("cat")
        if e.get("ph") == "X" and cat in DEVICE_CATEGORIES:
            key = (cat, e.get("name", ""))
            totals[key] += float(e.get("dur", 0.0))
            counts[key] += 1
    rows = sorted(((t, cat, name, counts[cat, name]) for (cat, name), t in totals.items()),
                  reverse=True)
    by_cat = defaultdict(float)
    for t, cat, _, _ in rows:
        by_cat[cat] += t
    return dict(sorted(by_cat.items(), key=lambda x: -x[1])), rows[:top]


def print_trace_summary(trace_dir: str, top: int = 15) -> None:
    """``summarize_trace`` for a reader (``cli profile-stats``)."""
    by_cat, rows = summarize_trace(trace_dir, top)
    if not by_cat:
        print(f"no device events in {_newest_trace(trace_dir)} (recorded without a card); "
              "host op times are not device time")
        return
    total = sum(by_cat.values()) or 1.0
    print(f"device time by category ({total:,.0f} us total):")
    for cat, t in by_cat.items():
        print(f"  {t:12,.0f} us {100 * t / total:5.1f}%  {cat}")
    print(f"top {len(rows)} ops:")
    for t, cat, name, occ in rows:
        print(f"  {t:10,.0f} us {100 * t / total:4.1f}% x{occ:<5d} [{cat}] {name}")


# Ops whose output is memory not yet written: its bits are whatever was there.
# Views are not checked either: they make no value, and a view of such memory
# (a slice of an empty buffer about to be filled) shows those bits too.
_UNWRITTEN = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                        "new_empty_strided", "resize_"})


def _nan_mode_class():
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class _NanCheck(TorchDispatchMode):
        """Checks every floating output of every op for NaN, forward and
        backward, and raises ``FloatingPointError`` naming the op (not the
        outputs of views and of ops that allocate without writing)."""

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.is_view or func.overloadpacket.__name__ in _UNWRITTEN:
                return out
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if (isinstance(t, torch.Tensor) and t.is_floating_point()
                        and bool(torch.isnan(t).any())):
                    raise FloatingPointError(f"NaN in the output of {func}")
            return out

    return _NanCheck


_nan_mode = None  # the process's NaN check while it is on (a debug switch, as jax_debug_nans)


def enable_nan_debugging() -> None:
    """Raise on the first NaN that any op produces, forward or backward
    (debug only; every op then waits for the device).  The forward check is
    a dispatch mode over every op, which cannot run inside a CUDA graph: a
    chunk of ``steps_per_dispatch`` steps then runs eagerly
    (``nan_debugging()``); autograd's anomaly mode also names the backward
    function."""
    global _nan_mode
    import torch

    if _nan_mode is None:
        _nan_mode = _nan_mode_class()()
        _nan_mode.__enter__()
        torch.autograd.set_detect_anomaly(True, check_nan=True)


def disable_nan_debugging() -> None:
    """Undo ``enable_nan_debugging``."""
    global _nan_mode
    import torch

    if _nan_mode is not None:
        _nan_mode.__exit__(None, None, None)
        _nan_mode = None
        torch.autograd.set_detect_anomaly(False)


def nan_debugging() -> bool:
    """Whether ``enable_nan_debugging`` is on."""
    return _nan_mode is not None


def _leaves(tree, path: str = "") -> List[Tuple[str, object]]:
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, f"{path}/{k}" if path else str(k))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{path}/{i}" if path else str(i))]
    return [(path, tree)]


def assert_finite_tree(tree, label: str = "tree") -> None:
    """Every leaf of ``tree`` (a dict or list of tensors, arrays or numbers,
    nested) is finite; the ``AssertionError`` names ``label`` and the
    leaf's path."""
    for path, leaf in _leaves(tree):
        if hasattr(leaf, "detach"):
            leaf = leaf.detach().float().cpu().numpy()
        a = np.asarray(leaf, dtype=np.float64)
        bad = int((~np.isfinite(a)).sum())
        if bad:
            raise AssertionError(f"non-finite values in {label}: leaf {path or '<root>'} has "
                                 f"{bad} of {a.size}")
