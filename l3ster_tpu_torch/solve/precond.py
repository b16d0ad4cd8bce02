"""Operator-based preconditioners (PyTorch port of ``l3ster_tpu.solve.precond``).

This slice ports :class:`Identity` and :class:`Jacobi`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["Identity", "Jacobi"]


@dataclass(frozen=True)
class Identity:
    """No preconditioning."""

    supports_lattice_layout = True

    def setup(self, system, layout="dof"):
        return lambda r: r


@dataclass(frozen=True)
class Jacobi:
    """Inverted thresholded diagonal (``NativePreconditioners.hpp`` NativeJacobi)."""

    threshold: float = 1e-14
    supports_lattice_layout = True

    def setup(self, system, layout="dof"):
        """apply(r) on (n_dofs, n_rhs) vectors of the given layout."""
        d = system.diagonal()
        inv = torch.where(d.abs() > self.threshold, 1.0 / d, torch.ones_like(d))
        if layout == "lattice":
            inv = system.to_lattice_layout(inv)
        inv = inv[:, None]
        return lambda r: inv * r
