"""Tracing, profiling and debug hooks (counterpart of
``mmtraj/utils/profiling.py``), over ``torch.profiler``.

``trace_ctx`` records the enclosed region, host and card, and writes a
Chrome trace (``*.pt.trace.json``) under ``{out_dir}/profile``;
``annotate`` names a region inside it; ``summarize_trace`` reads a trace
offline and totals its device events (``cli profile-stats``).  Debug aids:
``enable_nan_debugging`` raises on the first NaN that any op produces,
forward or backward (slow: every op's output is checked on the host), and
``assert_finite_tree`` checks every leaf of a dict or list of tensors and
arrays.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import socket
import time
from collections import defaultdict
from typing import Iterator, List, Optional, Tuple

import numpy as np

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


def annotate(name: str):
    """A named region inside a trace (``torch.profiler.record_function``)."""
    import torch

    return torch.profiler.record_function(name)


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
