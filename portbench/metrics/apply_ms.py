"""Milliseconds per operator apply (``operator_parts`` in the solver's layout), by CUDA events."""

PROBES = ("apply_events",)


def read(ctx):
    return ctx["probes"]["apply_events"]
