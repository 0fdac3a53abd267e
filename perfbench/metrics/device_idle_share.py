"""Percent of the profiled slice's wall time in which no operation ran
on the card: 1 - (union of the profiler's device operations / the
slice's host-clock seconds)."""


def read(ctx: dict):
    p = ctx["profile"]
    if not p:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
