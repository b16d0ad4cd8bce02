"""Plain least-squares FEM on hexahedra: the yardstick's own operator.

Independent of the measured program: GLL nodes, Gauss-Legendre quadrature,
Lagrange bases and the trilinear geometry are worked out here with numpy,
and the operator is applied with plain torch in float64, element block by
element block.  For the first-order system ``A0 u + sum_d A_d du/dx_d = 0``
with value-only boundary equations ``B(n) u = 0`` on some element sides,
the normal-equation operator is

    K u = sum_e sum_q w_q |J_q| M_q^T M_q u_e + sum_faces sum_q w_q dA_q N_q^T B^T B N_q u_e,

with ``M_q = A0 N_q + sum_d A_d dN_q/dx_d``.  Local nodes and quadrature
points are ordered with x fastest; an element's 8 vertices likewise.
Nothing here imports the program, JAX or the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


def quadrature_points(cfg: dict) -> int:
    """Gauss points per axis of a configuration: the upstream rule
    (``algsys/AssembleLocalSystem.hpp``) QO = 2 (vo p + do (p - 1)) for the
    ``value_order`` vo and ``derivative_order`` do it states, QO / 2 + 1 points."""
    p = cfg["order"]
    return cfg["value_order"] * p + cfg["derivative_order"] * max(p - 1, 0) + 1


def gauss_legendre(n: int) -> tuple[np.ndarray, np.ndarray]:
    return np.polynomial.legendre.leggauss(n)


def gauss_lobatto_nodes(n: int) -> np.ndarray:
    """The n Gauss-Lobatto-Legendre abscissae on [-1, 1], ascending."""
    inner = np.polynomial.legendre.Legendre.basis(n - 1).deriv().roots()
    return np.concatenate([[-1.0], np.sort(inner.real), [1.0]])


def lagrange_1d(nodes: np.ndarray, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Values and derivatives (len(x), len(nodes)) of the Lagrange basis on ``nodes``."""
    n = len(nodes)
    val = np.ones((len(x), n))
    der = np.zeros((len(x), n))
    for j in range(n):
        others = [m for m in range(n) if m != j]
        den = np.prod([nodes[j] - nodes[m] for m in others])
        for m in others:
            val[:, j] *= x - nodes[m]
        for k in others:
            term = np.ones(len(x))
            for m in others:
                if m != k:
                    term *= x - nodes[m]
            der[:, j] += term
        val[:, j] /= den
        der[:, j] /= den
    return val, der


def _tensor3(pts_axes) -> tuple[np.ndarray, np.ndarray]:
    """3D tables from 1D ones: values (Q, n) and reference derivatives (3, Q, n)
    at the tensor points, x fastest in both points and nodes.  ``pts_axes``:
    for each axis, (values, derivatives) of the 1D basis at that axis' points."""
    (vx, dx), (vy, dy), (vz, dz) = pts_axes
    V = np.einsum("ka,jb,ic->ijkcba", vx, vy, vz)
    Dx = np.einsum("ka,jb,ic->ijkcba", dx, vy, vz)
    Dy = np.einsum("ka,jb,ic->ijkcba", vx, dy, vz)
    Dz = np.einsum("ka,jb,ic->ijkcba", vx, vy, dz)
    q = V.shape[0] * V.shape[1] * V.shape[2]
    n = V.shape[3] * V.shape[4] * V.shape[5]
    return V.reshape(q, n), np.stack([Dx.reshape(q, n), Dy.reshape(q, n), Dz.reshape(q, n)])


def trilinear_tables(pts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Trilinear shape values (Q, 8) and reference derivatives (3, Q, 8) at points (Q, 3)."""
    lat = np.array([[b & 1, (b >> 1) & 1, (b >> 2) & 1] for b in range(8)])
    s = np.where(lat == 1, 1.0, -1.0)  # (8, 3)
    f = (1.0 + pts[:, None, :] * s[None]) / 2.0  # (Q, 8, 3)
    val = f.prod(axis=-1)
    der = np.stack([s[None, :, a] / 2.0 * f[:, :, (a + 1) % 3] * f[:, :, (a + 2) % 3] for a in range(3)])
    return val, der


def reference_nodes(order: int) -> np.ndarray:
    """Reference coordinates (n, 3) of the GLL lattice nodes, x fastest."""
    g = gauss_lobatto_nodes(order + 1)
    n1 = order + 1
    idx = np.arange(n1**3)
    return np.stack([g[idx % n1], g[(idx // n1) % n1], g[idx // n1**2]], axis=-1)


def element_nodes_xyz(verts: np.ndarray, order: int) -> np.ndarray:
    """Physical coordinates (E, n, 3) of every element's GLL nodes under the trilinear map."""
    val, _ = trilinear_tables(reference_nodes(order))
    return np.einsum("nv,evi->eni", val, verts)


class HexLSFEM:
    """The normal-equation operator of one first-order system on a hex mesh.

    ``verts`` (E, 8, 3) element vertices; ``conn`` (E, n) global node ids of
    each element's GLL nodes; ``A`` (4, n_eq, c): A0 and the three
    derivative operators; ``faces``: {side: element indices} of the sides
    carrying the value-only boundary equation ``B(n) = sum_d n_d Bn[d]``
    with ``Bn`` (3, 1, c).  Sides 2a / 2a+1 lie at reference coordinate
    -1 / +1 of axis a.  ``q1``: Gauss points per axis."""

    def __init__(self, verts, conn, n_nodes, order, q1, A, Bn, faces, device, block_bytes=1 << 30):
        self.device = torch.device(device)
        self.order, self.q1, self.n_nodes = order, q1, n_nodes
        self.verts = torch.as_tensor(verts, dtype=torch.float64, device=self.device)
        self.conn = torch.as_tensor(conn, dtype=torch.int64, device=self.device)
        self.A = torch.as_tensor(A, dtype=torch.float64, device=self.device)
        self.Bn = torch.as_tensor(Bn, dtype=torch.float64, device=self.device)
        self.c = self.A.shape[2]
        self.faces = {s: torch.as_tensor(e, dtype=torch.int64, device=self.device) for s, e in faces.items()}
        gll = gauss_lobatto_nodes(order + 1)
        xg, wg = gauss_legendre(q1)
        b1 = lagrange_1d(gll, xg)
        V, D = _tensor3((b1, b1, b1))
        idx = np.arange(q1**3)
        pts = np.stack([xg[idx % q1], xg[(idx // q1) % q1], xg[idx // q1**2]], axis=-1)
        w = wg[idx % q1] * wg[(idx // q1) % q1] * wg[idx // q1**2]
        gv, gd = trilinear_tables(pts)
        t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=self.device)
        self.vol = (t(V), t(D), t(w), t(gd))
        self.side = {}
        for side in self.faces:
            axis, val = side // 2, (-1.0 if side % 2 == 0 else 1.0)
            end = lagrange_1d(gll, np.array([val]))
            axes = [b1, b1, b1]
            axes[axis] = end
            Vs, _ = _tensor3(axes)
            fidx = np.arange(q1**2)
            fa = [a for a in range(3) if a != axis]
            fp = np.zeros((q1**2, 3))
            fp[:, fa[0]], fp[:, fa[1]], fp[:, axis] = xg[fidx % q1], xg[fidx // q1], val
            fw = wg[fidx % q1] * wg[fidx // q1]
            # the face points in the order _tensor3 produced them (x fastest over the free axes)
            _, fgd = trilinear_tables(fp)
            self.side[side] = (t(Vs), t(fw), t(fgd), axis)
        per_elem = 8 * (q1**3) * (4 * self.c * 3 + 3 * self.A.shape[1] + 30)
        self.block = max(1, int(block_bytes // per_elem))

    def _jac(self, gd, verts):
        """J (E, Q, 3, 3) with J[r, d] = dx_d / dxi_r."""
        return torch.einsum("rqv,evd->eqrd", gd, verts)

    @torch.no_grad()
    def apply(self, X: torch.Tensor) -> torch.Tensor:
        """K X for X (n_nodes, c) in float64 on the reference's device."""
        X = X.to(device=self.device, dtype=torch.float64)
        Y = torch.zeros_like(X)
        V, D, w, gd = self.vol
        A0, Ad = self.A[0], self.A[1:]
        E = self.conn.shape[0]
        for s in range(0, E, self.block):
            sl = slice(s, min(E, s + self.block))
            conn = self.conn[sl]
            xe = X[conn]  # (e, n, c)
            J = self._jac(gd, self.verts[sl])
            Ji = torch.linalg.inv(J)  # Ji[d, r] = dxi_r / dx_d
            wq = w * torch.linalg.det(J).abs()
            u = torch.einsum("qn,enc->eqc", V, xe)
            gr = torch.einsum("rqn,enc->erqc", D, xe)
            gx = torch.einsum("eqdr,erqc->edqc", Ji, gr)
            R = torch.einsum("ic,eqc->eqi", A0, u) + torch.einsum("dic,edqc->eqi", Ad, gx)
            R = R * wq[..., None]
            t0 = torch.einsum("ic,eqi->eqc", A0, R)
            tx = torch.einsum("dic,eqi->edqc", Ad, R)
            tr = torch.einsum("eqdr,edqc->erqc", Ji, tx)
            ye = torch.einsum("qn,eqc->enc", V, t0) + torch.einsum("rqn,erqc->enc", D, tr)
            Y.index_add_(0, conn.reshape(-1), ye.reshape(-1, self.c))
        for side, elems in self.faces.items():
            Vs, fw, fgd, axis = self.side[side]
            for s in range(0, len(elems), self.block):
                el = elems[s: s + self.block]
                conn = self.conn[el]
                J = self._jac(fgd, self.verts[el])
                Ji = torch.linalg.inv(J)
                n = Ji[..., :, axis]  # J^-T e_axis: the side's normal direction
                n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
                fa = [a for a in range(3) if a != axis]
                dA = torch.linalg.vector_norm(torch.cross(J[..., fa[0], :], J[..., fa[1], :], dim=-1), dim=-1)
                B = torch.einsum("eqd,dic->eqic", n, self.Bn)
                u = torch.einsum("qn,enc->eqc", Vs, X[conn])
                R = torch.einsum("eqic,eqc->eqi", B, u) * (fw * dA)[..., None]
                ye = torch.einsum("qn,eqc->enc", Vs, torch.einsum("eqic,eqi->eqc", B, R))
                Y.index_add_(0, conn.reshape(-1), ye.reshape(-1, self.c))
        return Y
