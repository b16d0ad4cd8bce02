"""Percent of the window's wall time in which no device activity ran (the union of
all kernels, copies and sets in the profiler's trace of the window's solves)."""


def read(ctx):
    t = ctx.get("trace")
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
