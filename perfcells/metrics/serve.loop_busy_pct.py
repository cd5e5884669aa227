"""Share of the traced window in which the serve loop's thread worked: its
``serve.parse`` and ``serve.flush`` spans less the ``serve.emit_wait``
spans under them, over the window.  Near 100 the loop sets the pace; time
in ``serve.emit_wait`` is the writer's, in ``serve.input_wait`` the
arrivals'."""

from perfcells import spans as sp

UNIT = "%"


def read(ctx):
    t = ctx.get("trace")
    wall, _ = sp.loop_work_ns(sp.program_spans())
    if not t or t["window_s"] <= 0 or wall <= 0:
        return None
    return 100.0 * wall * 1e-9 / t["window_s"]
