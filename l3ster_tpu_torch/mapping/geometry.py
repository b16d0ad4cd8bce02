"""Reference-to-physical geometric mapping (PyTorch port of ``l3ster_tpu.mapping.geometry``).

The geometric map is order-1 (multilinear from the corner vertices); its
shape-function tables at the evaluation points are static numpy constants,
while the per-element Jacobian algebra is batched torch over elements.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..basis.tables import basis_at_points
from ..mesh.traits import ElementType, native_dim, side_axis_sign

__all__ = [
    "corner_map_tables",
    "geometry_tables",
    "jacobians",
    "small_det",
    "small_inv",
    "map_to_physical",
    "physical_basis_derivatives",
    "boundary_normals_and_measure",
]


@lru_cache(maxsize=None)
def corner_map_tables(et: ElementType, pts_key) -> tuple[np.ndarray, np.ndarray]:
    """(N1, dN1) of the order-1 geometric map at the given points.

    ``pts_key`` is a hashable (bytes, shape) snapshot of float64 points, as
    :func:`geometry_tables` makes it.
    """
    raw, shape = pts_key
    pts = np.frombuffer(raw, dtype=np.float64).reshape(shape)
    b = basis_at_points(et, 1, pts)
    return b.values, b.derivatives  # (n_pts, n_verts), (n_pts, dim, n_verts)


def geometry_tables(et: ElementType, pts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Corner-map values/derivatives at reference points (cached)."""
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    return corner_map_tables(et, (pts.tobytes(), pts.shape))


def jacobians(dN1: torch.Tensor, verts: torch.Tensor) -> torch.Tensor:
    """J[e, q, i, j] = dx_i/dxi_j; dN1 (Q, dim, n_verts), verts (E, n_verts, dim)."""
    return torch.einsum("qjv,evi->eqij", dN1, verts)


def small_det(J: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., d, d) matrices, d <= 3, by cofactors."""
    d = J.shape[-1]
    if d == 1:
        return J[..., 0, 0]
    if d == 2:
        return J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
    if d == 3:
        return (
            J[..., 0, 0] * (J[..., 1, 1] * J[..., 2, 2] - J[..., 1, 2] * J[..., 2, 1])
            - J[..., 0, 1] * (J[..., 1, 0] * J[..., 2, 2] - J[..., 1, 2] * J[..., 2, 0])
            + J[..., 0, 2] * (J[..., 1, 0] * J[..., 2, 1] - J[..., 1, 1] * J[..., 2, 0])
        )
    raise ValueError(f"small_det supports d <= 3, got {d}")


def small_inv(J: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., d, d) matrices, d <= 3, via cofactors."""
    d = J.shape[-1]
    det = small_det(J)[..., None, None]
    if d == 1:
        return 1.0 / J
    if d == 2:
        a, b = J[..., 0, 0], J[..., 0, 1]
        c, e = J[..., 1, 0], J[..., 1, 1]
        adj = torch.stack([torch.stack([e, -b], dim=-1), torch.stack([-c, a], dim=-1)], dim=-2)
        return adj / det
    if d == 3:
        def m(i, j):
            return J[..., i, j]

        cof = [
            [
                m(1, 1) * m(2, 2) - m(1, 2) * m(2, 1),
                m(0, 2) * m(2, 1) - m(0, 1) * m(2, 2),
                m(0, 1) * m(1, 2) - m(0, 2) * m(1, 1),
            ],
            [
                m(1, 2) * m(2, 0) - m(1, 0) * m(2, 2),
                m(0, 0) * m(2, 2) - m(0, 2) * m(2, 0),
                m(0, 2) * m(1, 0) - m(0, 0) * m(1, 2),
            ],
            [
                m(1, 0) * m(2, 1) - m(1, 1) * m(2, 0),
                m(0, 1) * m(2, 0) - m(0, 0) * m(2, 1),
                m(0, 0) * m(1, 1) - m(0, 1) * m(1, 0),
            ],
        ]
        adj = torch.stack([torch.stack(row, dim=-1) for row in cof], dim=-2)
        return adj / det
    raise ValueError(f"small_inv supports d <= 3, got {d}")


def map_to_physical(N1: np.ndarray, verts: torch.Tensor) -> torch.Tensor:
    """Physical coordinates of the reference points; (n_pts, dim), on verts' device."""
    return torch.einsum("qv,vi->qi", torch.as_tensor(N1, dtype=verts.dtype, device=verts.device), verts)


def physical_basis_derivatives(J: torch.Tensor, ref_ders: np.ndarray) -> torch.Tensor:
    """dN/dx[q, i, n] from reference derivatives via J^{-T}.

    ref_ders: (n_qp, dim, n_nodes) static.  Returns (n_qp, dim, n_nodes) on J's device.
    """
    JinvT = small_inv(J).transpose(-1, -2)
    return torch.einsum("qij,qjn->qin", JinvT, torch.as_tensor(ref_ders, dtype=J.dtype, device=J.device))


def boundary_normals_and_measure(
    J: torch.Tensor, et: ElementType, side: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Outward unit normal (..., Q, dim) and surface measure dA (..., Q) on a side.

    n = sign * J^{-T} e_axis / |J^{-T} e_axis| (outward by construction);
    dA = sqrt(det(J_s^T J_s)) with J_s the Jacobian restricted to the facet axes.
    """
    dim = native_dim(et)
    axis, sign = side_axis_sign(et, side)
    Jinv = small_inv(J)
    n_raw = sign * Jinv[..., axis, :]  # row `axis` of J^{-1} = J^{-T} e_axis
    normal = n_raw / torch.linalg.vector_norm(n_raw, dim=-1, keepdim=True)
    other_axes = [a for a in range(dim) if a != axis]
    if other_axes:
        Js = J[..., other_axes]  # (..., dim, dim-1)
        G = torch.einsum("...ia,...ib->...ab", Js, Js)
        dA = torch.sqrt(small_det(G))
    else:
        dA = torch.ones(J.shape[:-2], dtype=J.dtype, device=J.device)
    return normal, dA
