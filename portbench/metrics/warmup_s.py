"""Seconds of the capped warm-up solve: the preconditioner's set-up, kernel loads and every shape once, a harness span."""


def read(ctx):
    return ctx["spans"].get("warmup_s")
