"""Seconds of mesh generation and promotion to order (``mesh.generators``, ``generate_mesh``), a harness span."""


def read(ctx):
    return ctx["spans"].get("mesh_s")
