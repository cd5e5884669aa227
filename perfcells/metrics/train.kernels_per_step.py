"""Device kernels a population step launches: kernel events in the traced
chunk over its steps (``torch.profiler``).  Graphed training is bound by
this count (thousands of ~2 us kernels a step), so fewer kernels a step
should raise ``train_windows_per_s``."""

UNIT = "kernels"


def read(ctx):
    s, steps = ctx.get("trace"), ctx.get("traced_steps")
    if not s or not steps:
        return None
    n = sum(count for count, _ in s["kernels"].values())
    return n / steps if n else None
