"""Ready-made PDE kernels (``models.kernels``)."""

from . import kernels

__all__ = ["kernels"]
