"""Share of the traced chunk in which no kernel, copy or set ran on the
card (``trace.summarize``'s union of device intervals)."""

UNIT = "%"


def read(ctx):
    s = ctx.get("trace")
    if not s or s["window_s"] <= 0 or s["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
