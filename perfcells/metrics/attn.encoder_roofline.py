"""The attention encoder's share of its roofline in a training step: the
least time of its work (``perfcells/costs_attn.py``: the block applications
the program's ``attn_layer`` counter counted in the traced eager step,
recomputations included, one backward of each block, and the parts around
them) over ``attn.encoder_ms``.  None where either is missing."""

from perfcells import costs_attn, harness

UNIT = "%"


def read(ctx):
    blocks = ctx.get("attn_layer")
    ms = harness.metric_reader("attn.encoder_ms").read(ctx)
    if not blocks or not ms:
        return None
    cfg = ctx["spec"]["config"]
    d = cfg["data"]
    least = costs_attn.encoder_least_time_s(cfg["model"], ctx["batch"], d["n_max"], d["obs_len"],
                                            blocks / ctx["eager_steps"], backward=True)
    return 100.0 * least / (ms * 1e-3)
