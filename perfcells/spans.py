"""The program's spans, for the per-layer metrics that read them.

``mmtraj_torch.utils.profiling.spans()`` holds every span the program began
while a torch profiler ran: in a run of a cell, the traced window alone.
Each has ``name``, ``thread``, ``start_ns`` and ``end_ns`` (wall clock,
``end_ns`` None while open), ``cpu_ns`` (the thread's CPU time over it),
``parent`` (an index into the same list), ``ids`` and ``outlived`` (the
profiler's flag was down when it closed).  The serve harness stops the
profiler inside the loop's last group, which outlives the window; the
profiler's flag only drops once its stop has collected the trace, which
can take seconds, so a span of another thread that ended in that time
reads as inside.  The readers take the spans that closed before the
earliest outliving span began.  A program that records no spans gives an
empty list, and each reader then None.
"""

from __future__ import annotations

from typing import Iterator, List


def program_spans() -> list:
    """The program's kept spans, or [] where it keeps none."""
    try:
        from mmtraj_torch.utils import profiling
    except ImportError:
        return []
    get = getattr(profiling, "spans", None)
    return list(get()) if get is not None else []


def cut_ns(spans: list):
    """The start of the earliest span that outlived the profiler, or None."""
    return min((s.start_ns for s in spans if s.outlived), default=None)


def inside(s, cut) -> bool:
    """Whether span ``s`` closed inside the traced window (before ``cut``)."""
    return s.end_ns is not None and not s.outlived and (cut is None or s.end_ns <= cut)


def closed(spans: list, name: str) -> Iterator:
    """The spans named ``name`` that closed inside the traced window."""
    cut = cut_ns(spans)
    return (s for s in spans if s.name == name and inside(s, cut))


def wall_ms(s) -> float:
    return (s.end_ns - s.start_ns) * 1e-6


def mean_ms(spans: list, name: str):
    """Mean wall ms of the closed spans named ``name``; None if none."""
    ms = [wall_ms(s) for s in closed(spans, name)]
    return sum(ms) / len(ms) if ms else None


def under(spans: list, s, names):
    """The innermost span named in ``names`` that ``s`` lies inside, or None."""
    p = s.parent
    while p is not None:
        if spans[p].name in names:
            return spans[p]
        p = spans[p].parent
    return None


LOOP_WORK = ("serve.parse", "serve.flush")


def loop_work_ns(spans: list) -> List[int]:
    """[wall ns, CPU ns] of the serve loop's work: its ``serve.parse`` and
    ``serve.flush`` spans less the ``serve.emit_wait`` spans under them
    (waiting for room in the writer's FIFO is not the loop's work)."""
    wall = cpu = 0
    cut = cut_ns(spans)
    for s in spans:
        if s.name in LOOP_WORK:
            if inside(s, cut) and under(spans, s, LOOP_WORK) is None:
                wall += s.end_ns - s.start_ns
                cpu += s.cpu_ns
        elif s.name == "serve.emit_wait":
            work = under(spans, s, LOOP_WORK)
            if work is not None and inside(work, cut):
                wall -= s.end_ns - s.start_ns
                cpu -= s.cpu_ns
    return [wall, cpu]
