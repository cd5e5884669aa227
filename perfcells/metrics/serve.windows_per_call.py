"""Windows a device call of the server carries (the harness's span around
each ``PredictServer`` dispatch), mean over the window's calls: how much
the loop's aggregation groups."""

UNIT = "windows"


def read(ctx):
    calls = ctx.get("calls")
    if not calls:
        return None
    return sum(b for _, b in calls) / len(calls)
