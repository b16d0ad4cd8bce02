"""Direct solvers (PyTorch port of ``l3ster_tpu.solve.direct``).

Analogs of the Amesos2-backed KLU2 / LAPACK solvers
(``solve/Amesos2Solvers.hpp:40-46``), and host solvers in the reference too:
``Klu2`` copies the Dirichlet-eliminated CSR of an assembled system to the
host and factors it with SciPy's SuperLU; ``Lapack`` densifies it on the host
and solves with numpy in float64.  The solution goes back to the system's
device in its dtype.  Both require the GLOBAL_ASSEMBLY evaluation strategy
(an :class:`~l3ster_tpu_torch.algsys.system.AssembledSystem`, or a
:class:`~l3ster_tpu_torch.parallel.distributed.DistributedSystem`, whose
partial matrices are gathered to the host).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .interface import IterSolveResult

__all__ = ["Klu2", "Lapack"]


def _host_system(system):
    """(SciPy CSR of the Dirichlet-eliminated matrix, host float64 effective
    rhs (n, n_rhs), put(x)) of an assembled system, or of a distributed one
    under GLOBAL_ASSEMBLY: its shards' partial matrices gathered to one host
    CSR, and the solution scattered back to the stacked layout (the
    Amesos2-on-a-distributed-matrix analog, ``solve/Amesos2Solvers.hpp:13-49``)."""
    import scipy.sparse as sp

    if getattr(system, "gathered_csr", None) is not None:
        data, indices, indptr, n = system.gathered_csr()
        A = sp.csr_matrix((data, indices, indptr), shape=(n, n))
        return A, system.effective_rhs_global(), system._set_solution_global
    if getattr(system, "eliminated_csr", None) is None:
        raise TypeError(f"{type(system).__name__} has no assembled matrix: use GLOBAL_ASSEMBLY")
    data, indices, indptr, n = system.eliminated_csr()
    A = sp.csr_matrix((data.cpu().numpy().astype(np.float64), indices, indptr), shape=(n, n))
    b = system.effective_rhs().cpu().numpy().astype(np.float64)

    def put(x):
        system.set_solution_vector(torch.as_tensor(x, dtype=system.dtype, device=system.device))

    return A, b, put


def _finish(A, x, b, put) -> IterSolveResult:
    put(x)
    r = A @ x - b
    bn = np.linalg.norm(b, axis=0)
    res = float(np.max(np.linalg.norm(r, axis=0) / np.where(bn > 0, bn, 1.0)))
    return IterSolveResult(tol=res, num_iters=0)


@dataclass
class Klu2:
    """Host sparse LU via SciPy SuperLU on the Dirichlet-eliminated CSR."""

    def solve(self, system) -> IterSolveResult:
        import scipy.sparse.linalg as spla

        A, b, put = _host_system(system)
        lu = spla.splu(A.tocsc())
        x = np.stack([lu.solve(b[:, j]) for j in range(b.shape[1])], axis=1)
        return _finish(A, x, b, put)


@dataclass
class Lapack:
    """Dense host solve (float64) of the Dirichlet-eliminated system."""

    def solve(self, system) -> IterSolveResult:
        A, b, put = _host_system(system)
        dense = A.toarray()
        return _finish(dense, np.linalg.solve(dense, b), b, put)
