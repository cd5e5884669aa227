"""Open-loop Poisson arrivals at one rate: ``{"kind": "poisson",
"rate_per_s": r}``."""


def pieces(spec: dict, seconds: float) -> list:
    """-> [(start_s, end_s, rate_per_s)]: one piece over the whole window."""
    return [(0.0, seconds, float(spec["rate_per_s"]))]
