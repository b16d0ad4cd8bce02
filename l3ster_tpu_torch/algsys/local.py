"""Element-local least-squares quantities (PyTorch port of ``l3ster_tpu.algsys.local``).

The least-squares normal equations for the first-order system
``A0 u + sum_d A_d du/dx_d = f`` are, per element,

    K_e = sum_q w_q |J_q|  M_q^T M_q,     F_e = sum_q w_q |J_q| M_q^T f_q,

where ``M_q[:, (n,u)] = sum_d A_d(x_q)[:, u] * B_d[q, n]`` with ``B_0`` the
basis values and ``B_d`` the physical basis derivatives.  This module ports
what the matrix-free system needs: geometry, the batched kernel evaluation,
the right-hand side and operator diagonal (direct and sum-factorized), and
the local applies of the gather-based paths (direct, dense-basis and
sum-factorized, constant A).  Everything is batched over elements (leading
axis E).

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
    "eval_residual_kernel",
    "local_apply_direct",
    "local_apply_dense_const",
    "local_apply_sumfact_const",
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


def _eval_points(kernel, geom: ElementGeometry, time):
    """Map ``kernel.evaluate`` over the E*Q points of a field-free contribution
    with ``torch.func.vmap``; outputs keep their per-point shapes behind E*Q."""
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

        return torch.func.vmap(one)(vals, ders, xyz, nrm)

    def one(v, d, x):
        return kernel.evaluate(DomainInput(v, d, SpaceTimePoint(x, t)), dtype, device)

    return torch.func.vmap(one)(vals, ders, xyz)


def eval_equation_kernel(kernel, geom: ElementGeometry, time=0.0):
    """Evaluate a wrapped equation kernel at all (element, qp) of a field-free
    contribution.  Returns A (E, Q, dim+1, n_eq, n_unk) and f (E, Q, n_eq, n_rhs).
    """
    E, Q = geom.weights.shape
    A, f = _eval_points(kernel, geom, time)
    return A.reshape((E, Q) + A.shape[1:]), f.reshape((E, Q) + f.shape[1:])


def eval_residual_kernel(kernel, geom: ElementGeometry, time=0.0):
    """Evaluate a wrapped residual kernel at all (element, point) of a field-free
    contribution -> (E, Q, n_eq, n_rhs)."""
    E, Q = geom.weights.shape
    f = _eval_points(kernel, geom, time)
    return f.reshape((E, Q) + f.shape[1:])


def _basis_stack(tables: DomainTables, geom: ElementGeometry) -> torch.Tensor:
    """B (E, Q, dim+1, n_nodes): values then physical derivatives."""
    E = geom.weights.shape[0]
    N = _const(tables.values, geom.weights)[None, :, None, :].expand(
        E, tables.n_qp, 1, tables.values.shape[1]
    )
    return torch.cat([N, geom.phys_ders], dim=2)


def local_apply_direct(
    A: torch.Tensor, B: torch.Tensor, weights: torch.Tensor, x_loc: torch.Tensor
) -> torch.Tensor:
    """Matrix-free local operator apply: y_e = sum_q w_q M_q^T (M_q x_e).

    A (E,Q,dim+1,n_eq,n_unk), B (E,Q,dim+1,n_nodes), weights (E,Q),
    x_loc (E, n_nodes, n_unk) -> y (E, n_nodes, n_unk).  Never materializes M.
    """
    g = torch.einsum("eqdn,enu->eqdu", B, x_loc)
    r = torch.einsum("eqdiu,eqdu->eqi", A, g)
    t = torch.einsum("eqdiu,eqi->eqdu", A, r * weights[:, :, None])
    return torch.einsum("eqdn,eqdu->enu", B, t)


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


def _qp_algebra_const(A: np.ndarray, Ji_t, w_t, vals_l, rd, dim: int, c: int, dtype):
    """Constant-coefficient per-QP algebra on (E*Q,) vectors: A's scalars are
    Python floats and structural zeros are skipped entirely.

    vals_l[u], rd[j][u] -> (EQ,) reference-space values/derivatives; Ji_t
    (dim, dim, EQ); w_t (EQ,).  Returns (t0 [u], tr [j][u]), the
    reference-space transpose integrands.  The plain version of the per-QP
    kernel (``ops/qp.py``).
    """
    d1, n_eq = A.shape[0], A.shape[1]
    EQ = w_t.shape[0]
    pders = [
        [sum(Ji_t[j, i] * rd[j][u] for j in range(dim)) for u in range(c)] for i in range(dim)
    ]
    g = [vals_l] + pders

    def zeros():
        return torch.zeros((EQ,), dtype=dtype, device=w_t.device)

    def dotA(i):
        terms = [float(A[d, i, u]) * g[d][u] for d in range(d1) for u in range(c) if A[d, i, u] != 0.0]
        return sum(terms) if terms else zeros()

    rw = [dotA(i) * w_t for i in range(n_eq)]

    def dotAT(d, u):
        terms = [float(A[d, i, u]) * rw[i] for i in range(n_eq) if A[d, i, u] != 0.0]
        return sum(terms) if terms else zeros()

    t = [[dotAT(d, u) for u in range(c)] for d in range(d1)]
    tr = [[sum(Ji_t[j, i] * t[1 + i][u] for i in range(dim)) for u in range(c)] for j in range(dim)]
    return t[0], tr


def local_apply_dense_const(
    A_const: np.ndarray, Ji_t: torch.Tensor, w_t: torch.Tensor, Ball: torch.Tensor, dim: int,
    x_loc: torch.Tensor,
) -> torch.Tensor:
    """Dense-basis local apply for constant-coefficient kernels, any element.

    Two basis matmuls (``ops/dense_eval.py``) around the per-QP kernel
    (``ops/qp.py``), which reads and writes the matmuls' (E, c, dim+1, Q)
    layout.  x_loc (E, n_nodes, c) -> y (E, n_nodes, c).
    """
    from ..ops.dense_eval import dense_interpolate_channels, dense_transpose_channels
    from ..ops.qp import qp_algebra_const

    G = dense_interpolate_channels(x_loc, Ball, dim)
    return dense_transpose_channels(qp_algebra_const(A_const, G, Ji_t, w_t), Ball)


def local_apply_sumfact_const(
    A_const: np.ndarray, Ji_t: torch.Tensor, w_t: torch.Tensor, E: int, order: int, q_order: int,
    dim: int, x_loc: torch.Tensor,
) -> torch.Tensor:
    """Sum-factorized local apply for constant-coefficient kernels (Quad/Hex):
    sweeps to the QPs, the per-QP chain with A's scalars, transpose sweeps.
    The plain version of the fused kernel (``ops/sumfact_fused.py``)."""
    from ..ops.sumfact import sumfact_interpolate, sumfact_tables_1d, sumfact_transpose_channels

    N1, D1, _ = sumfact_tables_1d(order, q_order)
    EQ = w_t.shape[0]
    c = x_loc.shape[-1]
    vals, rders = sumfact_interpolate(x_loc, N1, D1, dim)
    vals_l = [vals.reshape(EQ, c)[:, u] for u in range(c)]
    rd = [[rders[:, j].reshape(EQ, c)[:, u] for u in range(c)] for j in range(dim)]
    A = np.asarray(A_const, dtype=np.float64)
    t0, tr = _qp_algebra_const(A, Ji_t, w_t, vals_l, rd, dim, c, x_loc.dtype)
    return sumfact_transpose_channels(t0, tr, N1, D1, dim, E)
