"""The population step's model FLOPs (forward and backward products of every
lane, ``costs.train_step_products``) a second, over the untraced chunks of
the window, as a share of the card's dense TF32 peak."""

UNIT = "%"


def read(ctx):
    if not ctx.get("untraced_steps"):
        return None
    cfg = ctx["spec"]["config"]
    m, d, t = cfg["model"], cfg["data"], cfg["train"]
    costs = ctx["costs"]
    per_step = ctx["lanes"] * costs.train_step_products(m, ctx["batch"], d["n_max"],
                                                        t["variety_n"], d["obs_len"],
                                                        d["pred_len"])
    return 100.0 * per_step * ctx["untraced_steps"] / ctx["untraced_s"] / costs.TF32_FLOPS
