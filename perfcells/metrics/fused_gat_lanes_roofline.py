"""``fused_gat_lanes``'s share of its roofline in the population step: the
least time of its launches (``costs.lanes_cost`` at the step's two shapes:
the encoder's S x B graphs at each observed frame, the variety rollout's
S x variety_n x B at each predicted one) over their device time in the
traced chunk (kernel ``gat_kernel``; a population step launches it only
through ``fused_gat_lanes``)."""

from perfcells import trace

UNIT = "%"


def read(ctx):
    s = ctx.get("trace")
    if not s:
        return None
    n, secs = trace.kernel_events(s, "gat_kernel")
    if not n:
        return None
    cfg = ctx["spec"]["config"]
    m, d, t = cfg["model"], cfg["data"], cfg["train"]
    costs = ctx["costs"]
    S, B, N, H, heads = ctx["lanes"], ctx["batch"], d["n_max"], m["hidden_dim"], m["num_heads"]
    enc = costs.least_time_s(*costs.lanes_cost(S, B, N, H, H, heads, H))
    dec = costs.least_time_s(*costs.lanes_cost(S, t["variety_n"] * B, N, H, H, heads, H))
    per_step = d["obs_len"] * enc + d["pred_len"] * dec
    return 100.0 * per_step * (n / (d["obs_len"] + d["pred_len"])) / secs
