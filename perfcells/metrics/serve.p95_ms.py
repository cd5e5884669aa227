"""The 95th percentile of every request's latency, from its due time to the
write that completes its response line (a failed request is +inf).  Above
the rate the loop sustains it is the age of the backlog."""

UNIT = "ms"


def read(ctx):
    return ctx.get("latency_p95_ms")
