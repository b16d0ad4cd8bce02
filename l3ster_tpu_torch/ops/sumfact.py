"""Sum-factorized tensor-product sweeps (PyTorch port of ``l3ster_tpu.ops.sumfact``).

For Quad/Hex Lagrange elements the nodes <-> quadrature interpolation
factorizes into 1D contractions, batched over elements, in 2D and 3D.  The
rhs and diagonal pass uses the transpose sweeps (``algsys/local.py``), the
sum-factorized apply both directions.  The reference's odd-even split of the
1D tables is a TPU device and is not ported: each 1D contraction is one
einsum.  Layout: node index = ix + (p+1)*iy + (p+1)^2*iz, i.e. a reshape to
(..., nz, ny, nx) puts x in the last axis; QP indices use the same convention.
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
    "sumfact_interpolate",
    "sumfact_transpose",
    "sumfact_transpose_channels",
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


def _require_2d_3d(dim: int) -> None:
    if dim not in (2, 3):
        raise ValueError(f"sum factorization supports dim 2/3, got {dim}")


# 1D contractions of (E, [z,] y, x, c) tensors with a table M (n_in, n_out):
# out[..., o, ...] = sum_i M[i, o] * s[..., i, ...] along one spatial axis


def _cz(s, M):  # the z axis (axis 1) of (E, z, y, x, c)
    return torch.einsum("eabxc,an->enbxc", s, M)


def _cy(s, M):  # the y axis: axis 2 in 3D, axis 1 in 2D
    if s.dim() == 5:
        return torch.einsum("ezbxc,bn->eznxc", s, M)
    return torch.einsum("ebxc,bn->enxc", s, M)


def _cx(s, M):  # the x axis: the last one before the channel
    return torch.einsum("...ac,an->...nc", s, M)


def sumfact_interpolate(u: torch.Tensor, N1, D1, dim: int):
    """Nodes -> QPs: values and reference derivatives.

    u: (E, n_nodes, c) in lexicographic node order; N1, D1: (n_q1, p+1).
    Returns vals (E, Q, c) and ders (E, dim, Q, c) with Q = n_q1^dim,
    QP index = qx + n_q1*qy + n_q1^2*qz (same lex convention).
    """
    _require_2d_3d(dim)
    E, _, c = u.shape
    NT, DT = _tab(N1, u).T, _tab(D1, u).T  # (p+1, n_q1)
    p1 = NT.shape[0]
    t = u.reshape((E,) + (p1,) * dim + (c,))
    ax, adx = _cx(t, NT), _cx(t, DT)
    if dim == 2:
        vals, ddy, ddx = _cy(ax, NT), _cy(ax, DT), _cy(adx, NT)
        ders = (ddx, ddy)
    else:
        b, bdy, bdx = _cy(ax, NT), _cy(ax, DT), _cy(adx, NT)
        vals, ddz, ddy, ddx = _cz(b, NT), _cz(b, DT), _cz(bdy, NT), _cz(bdx, NT)
        ders = (ddx, ddy, ddz)
    return vals.reshape(E, -1, c), torch.stack([d.reshape(E, -1, c) for d in ders], dim=1)


def sumfact_transpose(t0: torch.Tensor, td: torch.Tensor, N1, D1, dim: int) -> torch.Tensor:
    """QPs -> nodes: exact transpose of :func:`sumfact_interpolate`.

    t0: (E, Q, c) value-part integrand; td: (E, dim, Q, c) reference-space
    derivative parts.  Returns y (E, n_nodes, c).
    """
    _require_2d_3d(dim)
    E, Q, c = t0.shape
    N, D = _tab(N1, t0), _tab(D1, t0)
    nq, p1 = N.shape
    sh = (E,) + (nq,) * dim + (c,)
    s0 = t0.reshape(sh)
    sd = [td[:, j].reshape(sh) for j in range(dim)]
    if dim == 2:
        a = _cy(s0, N) + _cy(sd[1], D)  # (E, y, qx, c)
        adx = _cy(sd[0], N)
    else:
        b = _cz(s0, N) + _cz(sd[2], D)  # (E, z, qy, qx, c)
        a = _cy(b, N) + _cy(_cz(sd[1], N), D)  # (E, z, y, qx, c)
        adx = _cy(_cz(sd[0], N), N)
    return (_cx(a, N) + _cx(adx, D)).reshape(E, p1**dim, c)


def sumfact_transpose_channels(t0_ch, td_ch, N1, D1, dim: int, E: int) -> torch.Tensor:
    """Transpose sweep of per-channel flat (E*Q,) vectors.

    t0_ch: list of c vectors (E*Q,); td_ch: [dim][c] vectors (E*Q,).
    Returns y (E, n_nodes, c), as :func:`sumfact_transpose` of the stacked
    channels.
    """
    t0 = torch.stack(t0_ch, dim=-1).reshape(E, -1, len(t0_ch))
    td = torch.stack([torch.stack(ch, dim=-1).reshape(E, -1, len(ch)) for ch in td_ch], dim=1)
    return sumfact_transpose(t0, td, N1, D1, dim)


def sumfact_transpose_general(s: torch.Tensor, axis_tables: list, dim: int) -> torch.Tensor:
    """Transpose sweep of a QP field with arbitrary per-axis 1D tables.

    s: (E, Q, c); axis_tables[a]: (n_q1, n_out) for axis a (a=0 is x).
    Returns (E, prod(n_out), c) in lexicographic node order.  Used for the
    sum-factorized operator diagonal, where the elementwise basis products
    B_j * B_k factorize into per-axis products of N1/D1 tables.
    """
    _require_2d_3d(dim)
    E, Q, c = s.shape
    T = [_tab(M, s) for M in axis_tables]
    nq = T[0].shape[0]
    t = s.reshape((E,) + (nq,) * dim + (c,))
    if dim == 3:
        t = _cz(t, T[2])
    return _cx(_cy(t, T[1]), T[0]).reshape(E, -1, c)
