"""``fused_decode``'s share of its roofline in a served call: the least time
of one launch at the artifact's K x batch graphs (``costs.decode_cost``)
times the launches, over their device time in the trace (kernel
``decode_kernel``)."""

from perfcells import trace

UNIT = "%"


def read(ctx):
    s = ctx.get("trace")
    if not s:
        return None
    n, secs = trace.kernel_events(s, "decode_kernel")
    if not n:
        return None
    m = ctx["spec"]["config"]["model"]
    costs = ctx["costs"]
    H, E, M = m["hidden_dim"], m["embed_dim"], m["num_mixtures"]
    one = costs.least_time_s(*costs.decode_cost(ctx["k"] * ctx["batch"], ctx["pred_len"],
                                                ctx["n_max"], H, E, H, m["num_heads"], M,
                                                costs.decoder_weights(H, E, H, M)))
    return 100.0 * n * one / secs
