"""A device call of the server from its dispatch to its result on the host
(the harness's spans around ``PredictServer.predict_async`` and the writer's
fetch, paired in order), mean over the window's calls."""

UNIT = "ms"


def read(ctx):
    calls, fetched = ctx.get("calls"), ctx.get("fetched")
    n = min(len(calls or ()), len(fetched or ()))
    if not n:
        return None
    return 1e3 * sum(f - c[0] for c, f in zip(calls[:n], fetched[:n])) / n
