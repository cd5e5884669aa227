"""Mean wall ms a request spends in ``serve.encode`` and ``serve.write``
(the response's .npy, base64 and JSON, and its print) on the writer's
thread, over the traced window's written requests."""

from perfcells import spans as sp

UNIT = "ms"


def read(ctx):
    s = sp.program_spans()
    written = {x.ids.get("request") for x in sp.closed(s, "serve.write")}
    if not written:
        return None
    total = sum(sp.wall_ms(x) for name in ("serve.encode", "serve.write")
                for x in sp.closed(s, name))
    return total / len(written)
