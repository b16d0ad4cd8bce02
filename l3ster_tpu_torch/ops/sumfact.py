"""Sum-factorized tensor-product sweeps (PyTorch port of ``l3ster_tpu.ops.sumfact``).

For Quad/Hex Lagrange elements the quadrature-to-nodes transpose sweep
factorizes into 1D contractions, batched over elements.  This slice needs
only the transpose sweeps, which the rhs and diagonal pass uses
(``algsys/local.py``), in 3D.  Layout: node index = ix + (p+1)*iy + (p+1)^2*iz,
i.e. a reshape to (..., nz, ny, nx) puts x in the last axis; QP indices use
the same convention.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..basis.tables import basis_1d
from ..math.gauss import gauss_legendre
from ..math.lagrange import lagrange_derivatives, lagrange_values
from ..mesh.traits import ElementType

__all__ = [
    "sumfact_tables_1d",
    "sumfact_transpose",
    "sumfact_transpose_general",
    "supports_sumfact",
]


@lru_cache(maxsize=None)
def sumfact_tables_1d(order: int, q_order: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(N1, D1, w1): 1D basis values/derivatives at the 1D Gauss points."""
    n1 = q_order // 2 + 1
    x1, w1 = gauss_legendre(n1)
    nodes = basis_1d(order)
    return lagrange_values(nodes, x1), lagrange_derivatives(nodes, x1), w1


def supports_sumfact(et: ElementType) -> bool:
    return et in (ElementType.QUAD, ElementType.HEX)


def _tab(M, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(M), dtype=like.dtype, device=like.device)


def _require_3d(dim: int) -> None:
    if dim != 3:
        raise NotImplementedError(
            f"the port's sum-factorized sweeps are 3D (ROADMAP.md queue A4), got {dim}D"
        )


def _cz(s, M):  # contract the z axis (axis 1) of (E, z, y, x, c)
    return torch.einsum("eabxc,an->enbxc", s, M)


def _cy(s, M):  # contract the y axis (axis 2)
    return torch.einsum("ezbxc,bn->eznxc", s, M)


def _cx(s, M):  # contract the x axis (axis 3)
    return torch.einsum("ezyac,an->ezync", s, M)


def sumfact_transpose(t0: torch.Tensor, td: torch.Tensor, N1, D1, dim: int) -> torch.Tensor:
    """QPs -> nodes: transpose of the nodes -> (values, reference derivatives) sweep.

    t0: (E, Q, c) value-part integrand; td: (E, dim, Q, c) reference-space
    derivative parts; N1, D1: (n_q1, p+1) 1D tables.  Returns y (E, n_nodes, c).
    """
    _require_3d(dim)
    E, Q, c = t0.shape
    N, D = _tab(N1, t0), _tab(D1, t0)
    nq, p1 = N.shape
    s0, sx, sy, sz = (t.reshape(E, nq, nq, nq, c) for t in (t0, td[:, 0], td[:, 1], td[:, 2]))
    b = _cz(s0, N) + _cz(sz, D)  # (E, z, qy, qx, c)
    a = _cy(b, N) + _cy(_cz(sy, N), D)  # (E, z, y, qx, c)
    adx = _cy(_cz(sx, N), N)
    return (_cx(a, N) + _cx(adx, D)).reshape(E, p1**3, c)


def sumfact_transpose_general(s: torch.Tensor, axis_tables: list, dim: int) -> torch.Tensor:
    """Transpose sweep of a QP field with arbitrary per-axis 1D tables.

    s: (E, Q, c); axis_tables[a]: (n_q1, n_out) for axis a (a=0 is x).
    Returns (E, prod(n_out), c) in lexicographic node order.  Used for the
    sum-factorized operator diagonal, where the elementwise basis products
    B_j * B_k factorize into per-axis products of N1/D1 tables.
    """
    _require_3d(dim)
    E, Q, c = s.shape
    Tx, Ty, Tz = (_tab(T, s) for T in axis_tables)
    nq = Tx.shape[0]
    t = s.reshape(E, nq, nq, nq, c)
    return _cx(_cy(_cz(t, Tz), Ty), Tx).reshape(E, -1, c)
