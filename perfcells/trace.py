"""Reading a ``torch.profiler`` trace of the measured window.

The arithmetic of the device's busy share and of device time by kernel: a
device event is a Kineto event of category ``kernel``, ``gpu_memcpy`` or
``gpu_memset``; the busy time is the union of their intervals inside the
window (so overlapping streams count once), the idle share the rest of the
window.  The window is the harness's own ``perfcells.window`` annotation.
Host events name what the host was doing in each idle gap.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
from collections import defaultdict
from typing import Iterator, Optional

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "perfcells.window"


class Capture:
    """What a traced window left: ``summary`` (``summarize``'s dict) once
    the profiler has stopped, or None where there was nothing to trace.
    ``stop()`` closes the traced window early: the enclosed code then runs
    on untraced (a no-op where nothing is traced, or once stopped)."""

    summary: Optional[dict] = None

    def __init__(self, stop=None):
        self._stop = stop

    def stop(self) -> None:
        if self._stop is not None:
            self._stop()


@contextlib.contextmanager
def traced(enabled: bool) -> Iterator[Capture]:
    """Profile the enclosed region (host and card) when enabled, inside a
    ``perfcells.window`` annotation, up to its end or to ``Capture.stop()``
    (called from the thread that entered); on leaving, the trace is written
    to a temporary file, read, summarised into the capture and deleted."""
    if not enabled:
        yield Capture()
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    prof = profile(activities=activities)
    window = record_function(WINDOW)
    running = [True]

    def stop() -> None:
        if not running[0]:
            return
        running[0] = False
        if card:
            torch.cuda.synchronize()
        window.__exit__(None, None, None)
        prof.stop()

    cap = Capture(stop)
    prof.start()
    window.__enter__()
    try:
        yield cap
    finally:
        stop()
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    finally:
        os.remove(path)
    cap.summary = summarize(events)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: list, top: int = 10) -> dict:
    """Trace events -> {"window_s", "busy_s", "kernels": {name: [count,
    seconds]}, "device_ops": top names by device seconds, "idle_gaps": the
    longest gaps by the innermost host event covering each gap's middle}."""
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError(f"the trace has no {WINDOW} annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, host = [], []
    kernels = defaultdict(lambda: [0, 0.0])
    ops = defaultdict(float)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        a = float(e.get("ts", 0.0))
        b = a + float(e.get("dur", 0.0))
        if cat in DEVICE_CATEGORIES:
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            dev.append((a, b))
            ops[e.get("name", "")] += (b - a) * 1e-6
            if cat == "kernel":
                k = kernels[e.get("name", "")]
                k[0] += 1
                k[1] += (b - a) * 1e-6
        elif cat in HOST_CATEGORIES and e.get("name") != WINDOW:
            host.append((a, b, e.get("name", "")))
    busy = _merge(dev)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((a - t, t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((w1 - t, t, w1))
    gaps.sort(reverse=True)
    named = []
    for length, a, b in gaps[:top]:
        mid = 0.5 * (a + b)
        cover = [(hb - ha, name) for ha, hb, name in host if ha <= mid <= hb]
        named.append([min(cover)[1] if cover else "(no host event)", length * 1e-6])
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "kernels": {k: list(v) for k, v in kernels.items()},
            "device_ops": [[n, s] for n, s in sorted(ops.items(), key=lambda x: -x[1])[:top]],
            "idle_gaps": named}


def kernel_events(summary: dict, *needles: str) -> tuple:
    """(launches, device seconds) of the kernels named by any of ``needles``
    as a whole word (``gat_kernel`` in ``void gat_kernel<4>(float const*)``)."""
    pats = [re.compile(rf"(?<![\w]){re.escape(x)}(?![\w])") for x in needles]
    n, s = 0, 0.0
    for name, (count, secs) in summary["kernels"].items():
        if any(p.search(name) for p in pats):
            n += count
            s += secs
    return n, s
