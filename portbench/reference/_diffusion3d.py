"""The 3D first-order diffusion problem of both benchmark configurations, in plain form.

Unknowns (T, qx, qy, qz); seven equations: div q = 0, q - grad T = 0 and
curl q = 0 (the upstream ``benchmarks/Diffusion3D.hpp`` kernel); value-only
adiabatic sides n . q = 0; Dirichlet T = a + b x.  Its exact solution,
T = a + b x and q = (b, 0, 0), lies in every trilinear-mapped GLL space of
order >= 1, so the reference holds an answer of its own beside its operator.

:class:`Judge` reads a solution in the program's node numbering, matches
the program's node coordinates to its own nodes (a bijection within 1e-8,
or it raises), and returns two numbers: ``err``, the largest nodal error
against the exact solution over the largest exact value, and ``res``, the
relative residual of the free equations of its own normal equations
(float64) at that solution.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial import cKDTree

from ._lsfem import HexLSFEM

MATCH_TOL = 1e-8  # node coordinates of the program against the reference's own


def operators() -> tuple[np.ndarray, np.ndarray]:
    """A (4, 7, 4): A0, Ax, Ay, Az; Bn (3, 1, 4): the adiabatic equation n . q by axis."""
    A = np.zeros((4, 7, 4))
    A0, Ax, Ay, Az = A
    Ax[0, 1] = Ay[0, 2] = Az[0, 3] = -1.0  # -div q
    A0[1, 1] = A0[2, 2] = A0[3, 3] = -1.0  # grad T - q
    Ax[1, 0] = Ay[2, 0] = Az[3, 0] = 1.0
    Ay[4, 3], Az[4, 2] = 1.0, -1.0  # curl q
    Ax[5, 3], Az[5, 1] = -1.0, 1.0
    Ax[6, 2], Ay[6, 1] = 1.0, -1.0
    Bn = np.zeros((3, 1, 4))
    for d in range(3):
        Bn[d, 0, 1 + d] = 1.0
    return A, Bn


class Judge:
    def __init__(self, verts, conn, coords, order, q1, adiabatic_faces, dirichlet_nodes, device):
        A, Bn = operators()
        self.n = len(coords)
        self.coords = coords
        self.op = HexLSFEM(verts, conn, self.n, order, q1, A, Bn, adiabatic_faces, device)
        self.device = self.op.device
        self.dir = torch.as_tensor(dirichlet_nodes, device=self.device)
        self.free = torch.ones((self.n, 4), dtype=torch.bool, device=self.device)
        self.free[self.dir, 0] = False
        x = torch.as_tensor(coords[:, 0], dtype=torch.float64, device=self.device)
        self.x = x
        g1 = torch.zeros((self.n, 4), dtype=torch.float64, device=self.device)
        gx = torch.zeros_like(g1)
        g1[self.dir, 0] = 1.0
        gx[self.dir, 0] = x[self.dir]
        # K applied to the Dirichlet extension of T = 1 and of T = x: the
        # right-hand side of the free equations for any (a, b) is a blend
        self.kg1, self.kgx = self.op.apply(g1)[self.free], self.op.apply(gx)[self.free]
        self._tree = None

    def match(self, program_coords: np.ndarray) -> np.ndarray:
        """For each program node, the reference node at its coordinates."""
        if self._tree is None:
            self._tree = cKDTree(self.coords)
        d, idx = self._tree.query(program_coords, k=1)
        if len(program_coords) != self.n or not (d < MATCH_TOL).all() or len(np.unique(idx)) != self.n:
            raise ValueError(
                f"program nodes do not match the reference's: {len(program_coords)} against {self.n}, "
                f"largest distance {float(d.max()):.3e}, {len(np.unique(idx))} distinct matches"
            )
        return idx

    def exact(self, a: float, b: float) -> torch.Tensor:
        u = torch.zeros((self.n, 4), dtype=torch.float64, device=self.device)
        u[:, 0] = a + b * self.x
        u[:, 1] = b
        return u

    @torch.no_grad()
    def judge(self, X: torch.Tensor, a: float, b: float) -> dict:
        """X (n, 4): the program's solution in reference node order.

        ``err``: largest nodal error over the largest exact value.  ``res``:
        ||(K x~)_F|| / ||(K g)_F||, the free equations' relative residual with
        the exact Dirichlet values g in x~.  ``res_c``: ||b - A x|| / ||b|| of
        the constrained system the solver sees (Dirichlet rows as identity,
        b = [-(K g)_F; g]), the norm of the solver's own stopping rule."""
        X = X.to(device=self.device, dtype=torch.float64)
        u = self.exact(a, b)
        err = float((X - u).abs().max() / u.abs().max())
        Xt = X.clone()
        Xt[self.dir, 0] = u[self.dir, 0]
        r = self.op.apply(Xt)[self.free]
        rhs = a * self.kg1 + b * self.kgx
        dres = X[self.dir, 0] - u[self.dir, 0]
        res_c = float(torch.sqrt(r.square().sum() + dres.square().sum())
                      / torch.sqrt(rhs.square().sum() + u[self.dir, 0].square().sum()))
        return {"err": err, "res": float(r.norm() / rhs.norm()), "res_c": res_c}


def shapes_of(n_elements: int, n_nodes: int, order: int, q1: int, unstructured: bool) -> dict:
    """The sizes the yardstick counts operations and bytes from."""
    A, _ = operators()
    return dict(n_elements=n_elements, n_nodes=n_nodes, n_dofs=4 * n_nodes, n_elem_nodes=(order + 1) ** 3,
                order=order, q1=q1, n_unk=4, n_eq=7, nnz=int((A != 0).sum()), unstructured=unstructured)


def element_sides(hexes: np.ndarray) -> np.ndarray:
    """Sorted vertex ids (E, 6, 4) of each hex's six sides (2a / 2a+1: axis a at -1 / +1)."""
    lat = np.array([[b & 1, (b >> 1) & 1, (b >> 2) & 1] for b in range(8)])
    sides = [np.nonzero(lat[:, s // 2] == s % 2)[0] for s in range(6)]
    return np.sort(np.stack([hexes[:, sv] for sv in sides], axis=1), axis=-1)


def locate_faces(hexes: np.ndarray, quads: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(element, side) of each boundary quad given by its four vertex ids."""
    keys = np.ascontiguousarray(element_sides(hexes).reshape(-1, 4))
    q = np.sort(quads, axis=1)
    kv = keys.view([("", keys.dtype)] * 4).reshape(-1)
    qv = np.ascontiguousarray(q).view([("", q.dtype)] * 4).reshape(-1)
    order = np.argsort(kv)
    pos = np.searchsorted(kv[order], qv)
    hit = order[np.minimum(pos, len(order) - 1)]
    if not (kv[hit] == qv).all():
        raise ValueError("a boundary quad is no side of any element")
    return hit // 6, hit % 6


def side_nodes(order: int, side: int) -> np.ndarray:
    """Local GLL node indices (x fastest) lying on a side."""
    n1 = order + 1
    idx = np.arange(n1**3)
    lat = np.stack([idx % n1, (idx // n1) % n1, idx // n1**2], axis=-1)
    return np.nonzero(lat[:, side // 2] == (0 if side % 2 == 0 else order))[0]
