"""A sequential teacher-forced step's model FLOPs (the attention encoder's,
bridge's and decoder's products forward and backward, remat's recomputation
left out: ``costs_attn.train_step_products``) a second, over the untraced
chunks of the window, as a share of the card's dense TF32 peak."""

from perfcells import costs_attn

UNIT = "%"


def read(ctx):
    if not ctx.get("untraced_steps"):
        return None
    cfg = ctx["spec"]["config"]
    d = cfg["data"]
    per_step = costs_attn.train_step_products(cfg["model"], ctx["batch"], d["n_max"],
                                              d["obs_len"], d["pred_len"])
    return (100.0 * per_step * ctx["untraced_steps"] / ctx["untraced_s"]
            / ctx["costs"].TF32_FLOPS)
