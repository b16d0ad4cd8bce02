"""Seconds of set-up: imports, kernel loads (or builds), mesh, assembly and the warm-up solve."""


def read(ctx):
    return ctx["setup_s"]
