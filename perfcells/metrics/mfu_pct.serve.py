"""The served requests' model FLOPs (encode and K rollouts of each request's
own agents, ``costs.forward_products``) over the time from the window's start
to the last answer, as a share of the card's dense TF32 peak."""

UNIT = "%"


def read(ctx):
    if not ctx.get("window_s"):
        return None
    return 100.0 * ctx["model_flops"] / ctx["window_s"] / ctx["costs"].TF32_FLOPS
