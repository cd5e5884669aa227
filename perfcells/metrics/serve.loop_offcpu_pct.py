"""Share of the serve loop's work (``serve.loop_busy_pct``'s spans) in
which its thread was off the CPU: wall time less the thread's CPU time.
Large, the loop waits for the GIL (the writer's Python), a lock or the
scheduler."""

from perfcells import spans as sp

UNIT = "%"


def read(ctx):
    wall, cpu = sp.loop_work_ns(sp.program_spans())
    if wall <= 0:
        return None
    return 100.0 * (wall - cpu) / wall
