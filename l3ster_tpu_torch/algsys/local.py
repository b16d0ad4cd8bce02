"""Element-local least-squares quantities (PyTorch port of ``l3ster_tpu.algsys.local``).

The least-squares normal equations for the first-order system
``A0 u + sum_d A_d du/dx_d = f`` are, per element,

    K_e = sum_q w_q |J_q|  M_q^T M_q,     F_e = sum_q w_q |J_q| M_q^T f_q,

where ``M_q[:, (n,u)] = sum_d A_d(x_q)[:, u] * B_d[q, n]`` with ``B_0`` the
basis values and ``B_d`` the physical basis derivatives.  This slice ports
what the matrix-free system needs: geometry, the batched kernel evaluation,
and the right-hand side and operator diagonal, both direct and
sum-factorized.  Everything is batched over elements (leading axis E).

Local DOF ordering is node-major: local dof = node * n_unknowns + unknown.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..basis.tables import BasisType, basis_at_quadrature, basis_at_side_quadrature
from ..common.kernel import BoundaryInput, DomainInput, SpaceTimePoint
from ..mapping.geometry import (
    boundary_normals_and_measure,
    geometry_tables,
    jacobians,
    small_det,
    small_inv,
)
from ..mesh.traits import ElementType, native_dim

__all__ = [
    "DomainTables",
    "domain_tables",
    "side_tables",
    "ElementGeometry",
    "element_geometry",
    "eval_equation_kernel",
    "local_rhs",
    "local_diagonal",
    "local_rhs_sumfact",
    "local_diagonal_sumfact",
]


@dataclass(frozen=True)
class DomainTables:
    """Static basis/quadrature/geometry tables for one (type, order, side?)."""

    element_type: ElementType
    order: int
    values: np.ndarray  # (Q, n_nodes)
    ref_ders: np.ndarray  # (Q, dim, n_nodes)
    weights: np.ndarray  # (Q,)
    points: np.ndarray  # (Q, dim) reference coordinates
    geom_values: np.ndarray  # (Q, n_verts)
    geom_ders: np.ndarray  # (Q, dim, n_verts)
    side: int | None = None  # set for boundary tables

    @property
    def n_qp(self) -> int:
        return len(self.weights)

    @property
    def dim(self) -> int:
        return native_dim(self.element_type)


@lru_cache(maxsize=None)
def domain_tables(
    et: ElementType, order: int, q_order: int, basis_type: BasisType = BasisType.LAGRANGE
) -> DomainTables:
    b = basis_at_quadrature(et, order, q_order, basis_type)
    gv, gd = geometry_tables(et, b.points)
    return DomainTables(et, order, b.values, b.derivatives, b.weights, b.points, gv, gd)


@lru_cache(maxsize=None)
def side_tables(
    et: ElementType, order: int, side: int, q_order: int, basis_type: BasisType = BasisType.LAGRANGE
) -> DomainTables:
    b = basis_at_side_quadrature(et, order, side, q_order, basis_type)
    gv, gd = geometry_tables(et, b.points)
    return DomainTables(et, order, b.values, b.derivatives, b.weights, b.points, gv, gd, side=side)


@dataclass
class ElementGeometry:
    """Per-(element, qp) geometric quantities; all leading axes (E, Q)."""

    xyz: torch.Tensor  # (E, Q, 3) physical point coordinates
    phys_ders: torch.Tensor | None  # (E, Q, dim, n_nodes)
    weights: torch.Tensor  # (E, Q) quadrature weight * measure
    normals: torch.Tensor | None = None  # (E, Q, dim) for boundary tables
    jac_inv: torch.Tensor | None = None  # (E, Q, dim, dim) inverse Jacobian


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=like.dtype, device=like.device)


def element_geometry(
    tables: DomainTables, verts: torch.Tensor, with_phys_ders: bool = True
) -> ElementGeometry:
    """Batched geometry for a block: verts (E, n_verts, 3) in the compute dtype.

    ``with_phys_ders=False`` skips materializing the (E, Q, dim, n_nodes)
    physical-derivative tables (the sum-factorized paths transform reference
    derivatives per QP with ``jac_inv`` instead).
    """
    dim = tables.dim
    gd = _const(tables.geom_ders, verts)
    gv = _const(tables.geom_values, verts)
    J = jacobians(gd, verts[:, :, :dim])  # (E, Q, dim, dim)
    Jinv = small_inv(J)
    physD = None
    if with_phys_ders:
        # physD[i, n] = sum_j Jinv[j, i] refD[j, n]  (= J^-T refD)
        physD = torch.einsum("eqji,qjn->eqin", Jinv, _const(tables.ref_ders, verts))
    xyz = torch.einsum("qv,evi->eqi", gv, verts)
    w = _const(tables.weights, verts)
    if tables.side is None:
        weights = w[None, :] * torch.abs(small_det(J))
        normals = None
    else:
        normals, dA = boundary_normals_and_measure(J, tables.element_type, tables.side)
        weights = w[None, :] * dA
    return ElementGeometry(xyz=xyz, phys_ders=physD, weights=weights, normals=normals, jac_inv=Jinv)


def eval_equation_kernel(kernel, geom: ElementGeometry, time=0.0):
    """Evaluate a wrapped equation kernel at all (element, qp) of a field-free
    contribution, mapped over the E*Q points with ``torch.func.vmap``.

    Returns A (E, Q, dim+1, n_eq, n_unk) and f (E, Q, n_eq, n_rhs).
    """
    p = kernel.params
    E, Q = geom.weights.shape
    dtype, device = geom.weights.dtype, geom.weights.device
    vals = torch.zeros((E * Q, p.n_fields), dtype=dtype, device=device)
    ders = torch.zeros((E * Q, p.dimension, p.n_fields), dtype=dtype, device=device)
    xyz = geom.xyz.reshape(E * Q, 3)
    t = torch.tensor(float(time), dtype=dtype, device=device)
    if kernel.is_boundary:
        if geom.normals is None:
            raise ValueError("boundary kernel requires boundary tables (with normals)")
        nrm = geom.normals.reshape(E * Q, -1)

        def one(v, d, x, n):
            return kernel.evaluate(BoundaryInput(v, d, SpaceTimePoint(x, t), n), dtype, device)

        A, f = torch.func.vmap(one)(vals, ders, xyz, nrm)
    else:

        def one(v, d, x):
            return kernel.evaluate(DomainInput(v, d, SpaceTimePoint(x, t)), dtype, device)

        A, f = torch.func.vmap(one)(vals, ders, xyz)
    return A.reshape((E, Q) + A.shape[1:]), f.reshape((E, Q) + f.shape[1:])


def _basis_stack(tables: DomainTables, geom: ElementGeometry) -> torch.Tensor:
    """B (E, Q, dim+1, n_nodes): values then physical derivatives."""
    E = geom.weights.shape[0]
    N = _const(tables.values, geom.weights)[None, :, None, :].expand(
        E, tables.n_qp, 1, tables.values.shape[1]
    )
    return torch.cat([N, geom.phys_ders], dim=2)


def local_rhs(A: torch.Tensor, B: torch.Tensor, weights: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """F_e = sum_q w_q M_q^T f_q without materializing M; (E, n_nodes, n_unk, n_rhs)."""
    fw = f * weights[:, :, None, None]
    t = torch.einsum("eqdiu,eqir->eqdur", A, fw)
    return torch.einsum("eqdn,eqdur->enur", B, t)


def local_diagonal(A: torch.Tensor, B: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """diag(K_e) (E, n_nodes, n_unk): sum_q w_q sum_i M[q,i,(n,u)]^2."""
    M = torch.einsum("eqdiu,eqdn->eqinu", A, B)
    return torch.einsum("eq,eqinu,eqinu->enu", weights, M, M)


def local_rhs_sumfact(
    A: torch.Tensor, geom: ElementGeometry, order: int, q_order: int, dim: int, f: torch.Tensor
) -> torch.Tensor:
    """F_e = sum_q w_q M_q^T f_q via the transpose sweep; (E, n_nodes, n_unk, n_rhs)."""
    from ..ops.sumfact import sumfact_tables_1d, sumfact_transpose

    N1, D1, _ = sumfact_tables_1d(order, q_order)
    fw = f * geom.weights[:, :, None, None]
    outs = []
    for r in range(f.shape[-1]):
        t = torch.einsum("eqdiu,eqi->eqdu", A, fw[..., r])  # (E, Q, dim+1, u)
        t_ref = torch.einsum("eqji,eqiu->ejqu", geom.jac_inv, t[:, :, 1:, :])
        outs.append(sumfact_transpose(t[:, :, 0, :], t_ref, N1, D1, dim))
    return torch.stack(outs, dim=-1)


def local_diagonal_sumfact(
    A: torch.Tensor, geom: ElementGeometry, order: int, q_order: int, dim: int
) -> torch.Tensor:
    """diag(K_e) (E, n_nodes, n_unk) without materializing M or basis stacks.

    Uses the reference-space expansion diag = sum_{j,k} G_jk (x) (Bhat_j o
    Bhat_k), where G_jk[q, u] = sum_i Ahat_j[q, i, u] Ahat_k[q, i, u] with
    Ahat_0 = A_0, Ahat_j = sum_d A_d Jinv[j, d], and the elementwise basis
    products Bhat_j o Bhat_k factorize into per-axis N1/D1 products.
    """
    from ..ops.sumfact import sumfact_tables_1d, sumfact_transpose_general

    N1, D1, _ = sumfact_tables_1d(order, q_order)
    Ahatd = torch.einsum("eqjd,eqdiu->eqjiu", geom.jac_inv, A[:, :, 1:])
    Ahat = torch.cat([A[:, :, :1], Ahatd], dim=2)
    G = torch.einsum("eqjiu,eqkiu->eqjku", Ahat, Ahat)  # (E, Q, d1, d1, u)
    Gw = G * geom.weights[:, :, None, None, None]
    NN, ND, DD = N1 * N1, N1 * D1, D1 * D1
    out = 0.0
    for j in range(dim + 1):
        for k in range(j, dim + 1):
            tabs = []
            for a in range(dim):
                both = (j == a + 1) + (k == a + 1)
                tabs.append(DD if both == 2 else (ND if both == 1 else NN))
            s = Gw[:, :, j, k, :] * (1.0 if j == k else 2.0)
            out = out + sumfact_transpose_general(s, tabs, dim)
    return out
