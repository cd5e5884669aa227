"""Mean wall ms of a device call's ``serve.dispatch`` span (in
``PredictServer.predict_async``: padding, the stream's draw, the copies in
and the eager program's launches), over the traced window's calls: the
host's cost to enqueue a call, which a graphed program would cut."""

from perfcells import spans as sp

UNIT = "ms"


def read(ctx):
    return sp.mean_ms(sp.program_spans(), "serve.dispatch")
