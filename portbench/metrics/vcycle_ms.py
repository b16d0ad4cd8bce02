"""Milliseconds per V-cycle of ``LowOrderMG`` (its ``setup_parts`` from the warm-up), by CUDA events."""

PROBES = ("vcycle_events",)


def read(ctx):
    return ctx["probes"]["vcycle_events"]
