"""Direct solvers (PyTorch port of ``l3ster_tpu.solve.direct``).

Analogs of the Amesos2-backed KLU2 / LAPACK solvers
(``solve/Amesos2Solvers.hpp:40-46``), and host solvers in the reference too:
``Klu2`` copies the Dirichlet-eliminated CSR of an assembled system to the
host and factors it with SciPy's SuperLU; ``Lapack`` densifies it on the host
and solves with numpy in float64.  The solution goes back to the system's
device in its dtype.  Both require the GLOBAL_ASSEMBLY evaluation strategy
(an :class:`~l3ster_tpu_torch.algsys.system.AssembledSystem`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .interface import IterSolveResult

__all__ = ["Klu2", "Lapack"]


def _assembled(system):
    """The system, if it holds an assembled matrix; else a TypeError."""
    if getattr(system, "eliminated_csr", None) is None:
        raise TypeError(f"{type(system).__name__} has no assembled matrix: use GLOBAL_ASSEMBLY")
    return system


def _host_rhs(system) -> np.ndarray:
    """The effective rhs as a host float64 array (n, n_rhs)."""
    return system.effective_rhs().cpu().numpy().astype(np.float64)


def _finish(system, A, x, b) -> IterSolveResult:
    system.set_solution_vector(torch.as_tensor(x, dtype=system.dtype, device=system.device))
    r = A @ x - b
    bn = np.linalg.norm(b, axis=0)
    res = float(np.max(np.linalg.norm(r, axis=0) / np.where(bn > 0, bn, 1.0)))
    return IterSolveResult(tol=res, num_iters=0)


@dataclass
class Klu2:
    """Host sparse LU via SciPy SuperLU on the Dirichlet-eliminated CSR."""

    def solve(self, system) -> IterSolveResult:
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        data, indices, indptr, n = _assembled(system).eliminated_csr()
        A = sp.csr_matrix((data.cpu().numpy().astype(np.float64), indices, indptr), shape=(n, n))
        b = _host_rhs(system)
        lu = spla.splu(A.tocsc())
        x = np.stack([lu.solve(b[:, j]) for j in range(b.shape[1])], axis=1)
        return _finish(system, A, x, b)


@dataclass
class Lapack:
    """Dense host solve (float64) of the Dirichlet-eliminated system."""

    def solve(self, system) -> IterSolveResult:
        dense, b = _assembled(system).eliminated_dense(), _host_rhs(system)
        return _finish(system, dense, np.linalg.solve(dense, b), b)
