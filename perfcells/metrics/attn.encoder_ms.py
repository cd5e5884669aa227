"""Device ms a training step of the kernels the attention encoder launched:
those launched inside its ``attn.encode`` span (the forward) and its
``attn.encode_grad`` span (its backward, remat's recomputation included),
in the eager step traced after the window (``perfcells.launches``).  A
faster encoder should raise ``train_windows_per_s``; None where the program
records neither span."""

from perfcells import launches
from perfcells import spans as sp

UNIT = "ms"


def read(ctx):
    rec = ctx.get("eager")
    if not rec or not rec["total_s"]:  # no device events: nothing ran on a card
        return None
    s = sp.program_spans()
    fwd, bwd = list(sp.closed(s, "attn.encode")), list(sp.closed(s, "attn.encode_grad"))
    if not fwd or not bwd:
        return None
    return 1e3 * launches.device_s_inside(rec, fwd + bwd) / ctx["eager_steps"]
