"""Device time by where the host launched it: which kernels a span of the
program enqueued, from a ``torch.profiler`` trace of an eager step.

A device event (a kernel, copy or set) carries the ``correlation`` of the
CUDA runtime or driver call that launched it, and that call's event lies on
the host's timeline.  The trace's clock is the spans' wall clock: an
event's ``ts`` is microseconds after the trace's ``baseTimeNanoseconds``
(``mmtraj_torch.utils.profiling.annotate``).  So the device seconds of a
span are those of the device events whose launch began inside it, on any
thread: the backward's spans run on autograd's device thread.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Iterable

from perfcells import trace as tracing

LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


def record(fn) -> dict:
    """Run ``fn()`` under the profiler (host and card) and synchronise ->
    {"launches": [(wall ns, correlation)], "device_s": {correlation: device
    seconds}, "total_s": every device event's seconds}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    with profile(activities=activities) as prof:
        fn()
        if card:
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            doc = json.load(fh)
    finally:
        os.remove(path)
    return summarize(doc)


def summarize(doc: dict) -> dict:
    """A Chrome trace's document -> ``record``'s dict."""
    base = int(doc.get("baseTimeNanoseconds", 0))
    launches, device, total = [], {}, 0.0
    for e in doc.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in tracing.DEVICE_CATEGORIES:
            secs = float(e.get("dur", 0.0)) * 1e-6
            total += secs
            if corr is not None:
                device[corr] = device.get(corr, 0.0) + secs
        elif e.get("cat") in LAUNCH_CATEGORIES and corr is not None:
            launches.append((base + int(round(float(e["ts"]) * 1000)), corr))
    return {"launches": launches, "device_s": device, "total_s": total}


def device_s_inside(rec: dict, spans: Iterable) -> float:
    """Device seconds of the events launched inside any of ``spans``
    (each with ``start_ns`` and ``end_ns``)."""
    iv = sorted((s.start_ns, s.end_ns) for s in spans)
    corrs = {c for t, c in rec["launches"] if any(a <= t <= b for a, b in iv)}
    return sum(rec["device_s"].get(c, 0.0) for c in corrs)
