"""Operator-based preconditioners (PyTorch port of ``l3ster_tpu.solve.precond``).

This slice ports :class:`Identity` and :class:`Jacobi`.  Every
preconditioner speaks the reference's protocol: ``setup(system)`` returns
``M(r)`` on dof-layout vectors, and ``setup_parts(system, layout)`` returns
``(apply(r, *consts), consts)`` for the given vector layout (``"dof"``, or
``"lattice"`` where ``supports_lattice_layout``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["Identity", "Jacobi"]


def _identity_apply(r, *pc):
    return r


def _jacobi_apply(r, inv):
    return inv[:, None] * r


@dataclass(frozen=True)
class Identity:
    """No preconditioning."""

    supports_lattice_layout = True

    def setup(self, system):
        return lambda r: r

    def setup_parts(self, system, layout="dof"):
        return _identity_apply, ()


@dataclass(frozen=True)
class Jacobi:
    """Inverted thresholded diagonal (``NativePreconditioners.hpp`` NativeJacobi).
    The reference's ``sweeps``, ``damping`` and ``lag`` are not ported
    (ROADMAP.md queue A8, preconditioners)."""

    threshold: float = 1e-14
    supports_lattice_layout = True

    def setup(self, system):
        apply, pc = self.setup_parts(system)
        return lambda r: apply(r, *pc)

    def setup_parts(self, system, layout="dof"):
        """(apply(r, inv), (inv,)) on (n_dofs, n_rhs) vectors of the given layout."""
        d = system.diagonal()
        inv = torch.where(d.abs() > self.threshold, 1.0 / d, torch.ones_like(d))
        if layout == "lattice":
            inv = system.to_lattice_layout(inv)
        return _jacobi_apply, (inv,)
