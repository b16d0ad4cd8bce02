"""Seconds from ``make_algebraic_system`` through ``end_assembly``, a harness span."""


def read(ctx):
    return ctx["spans"].get("assembly_s")
