"""Built-in structured mesh generator: the cube.

Analog of ``mesh/primitives/CubeMesh.hpp`` at order 1 with the reference's
domain/boundary ids (``CubeMesh.hpp:8-11``: domain=0, back=1, front=2,
bottom=3, top=4, left=5, right=6).  All connectivity is vectorized numpy;
node ids are lexicographic (x fastest), matching the reference generator's
numbering.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .core import ElementBlock, Mesh
from .traits import ElementType

__all__ = [
    "CubeMeshIds",
    "make_cube_mesh",
]


@dataclass(frozen=True)
class CubeMeshIds:
    domain: int = 0
    back: int = 1
    front: int = 2
    bottom: int = 3
    top: int = 4
    left: int = 5
    right: int = 6


def _as_dist(d) -> np.ndarray:
    d = np.asarray(d, dtype=np.float64)
    if d.ndim != 1 or len(d) < 2:
        raise ValueError("node distribution must be a 1D array of at least 2 points")
    return d


def make_cube_mesh(distx, disty=None, distz=None, ids: CubeMeshIds = CubeMeshIds()) -> Mesh:
    """Structured hex mesh with 6 quad boundaries (back/front = z-/z+,
    bottom/top = y-/y+, left/right = x-/x+, matching CubeMesh.hpp:10)."""
    distx = _as_dist(distx)
    disty = distx if disty is None else _as_dist(disty)
    distz = distx if distz is None else _as_dist(distz)
    nx, ny, nz = len(distx), len(disty), len(distz)
    ex, ey, ez = nx - 1, ny - 1, nz - 1

    gx, gy, gz = np.meshgrid(distx, disty, distz, indexing="ij")
    # node id = iz*nx*ny + iy*nx + ix
    nid = lambda ix, iy, iz: iz * nx * ny + iy * nx + ix
    coords = np.zeros((nx * ny * nz, 3))
    IX, IY, IZ = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    coords[nid(IX, IY, IZ).reshape(-1), 0] = gx.reshape(-1)
    coords[nid(IX, IY, IZ).reshape(-1), 1] = gy.reshape(-1)
    coords[nid(IX, IY, IZ).reshape(-1), 2] = gz.reshape(-1)

    ix, iy, iz = np.meshgrid(np.arange(ex), np.arange(ey), np.arange(ez), indexing="ij")
    ix, iy, iz = ix.reshape(-1), iy.reshape(-1), iz.reshape(-1)
    offs = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0), (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1)]
    hnodes = np.stack([nid(ix + a, iy + b, iz + c) for a, b, c in offs], axis=1).astype(np.int64)
    hverts = coords[hnodes]

    def quad_block(corner_ids: np.ndarray) -> ElementBlock:
        # corner_ids: (n_face, 4) global node ids in local lexicographic order
        verts = coords[corner_ids]
        return ElementBlock(ElementType.QUAD, 1, corner_ids.astype(np.int64), verts)

    def face_ids(fixed_axis: int, fixed_val: int) -> np.ndarray:
        axes = [a for a in range(3) if a != fixed_axis]
        na = [ex, ey, ez][axes[0]]
        nb = [ex, ey, ez][axes[1]]
        A, B = np.meshgrid(np.arange(na), np.arange(nb), indexing="xy")
        A, B = A.reshape(-1), B.reshape(-1)

        def make(a, b):
            c = [0, 0, 0]
            c[axes[0]], c[axes[1]], c[fixed_axis] = a, b, fixed_val
            return nid(c[0], c[1], c[2])

        return np.stack([make(A, B), make(A + 1, B), make(A, B + 1), make(A + 1, B + 1)], axis=1)

    domains = {
        ids.domain: [ElementBlock(ElementType.HEX, 1, hnodes, hverts)],
        ids.back: [quad_block(face_ids(2, 0))],
        ids.front: [quad_block(face_ids(2, nz - 1))],
        ids.bottom: [quad_block(face_ids(1, 0))],
        ids.top: [quad_block(face_ids(1, ny - 1))],
        ids.left: [quad_block(face_ids(0, 0))],
        ids.right: [quad_block(face_ids(0, nx - 1))],
    }
    return Mesh(
        dim=3,
        n_nodes=nx * ny * nz,
        node_coords=coords,
        domains=domains,
        boundary_ids=(ids.back, ids.front, ids.bottom, ids.top, ids.left, ids.right),
    )
