"""Mean wall ms of a request's ``serve.parse`` span (the program's
``_parse_request`` on the loop's thread: JSON, base64 and .npy decoding,
validation), over the traced window's requests."""

from perfcells import spans as sp

UNIT = "ms"


def read(ctx):
    return sp.mean_ms(sp.program_spans(), "serve.parse")
