"""Built-in mesh generators: the cube and the cylinder in a channel.

Analogs of ``mesh/primitives/`` at order 1 with the reference's
domain/boundary ids: ``CubeMesh.hpp:8-11`` (domain=0, back=1, front=2,
bottom=3, top=4, left=5, right=6) and ``CylinderInChannel2D.hpp:10-13``
(domain=0, bottom=1, top=2, left=3, right=4, cylinder=5), extruded along z
for ``CylinderInChannel3D.hpp`` with caps back=6, front=7.  All connectivity
is vectorized numpy; cube node ids are lexicographic (x fastest), matching
the reference generator's numbering.  Copied from ``l3ster_tpu.mesh.generators``
so that both packages build the same meshes, node for node.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .core import ElementBlock, Mesh
from .traits import ElementType

__all__ = [
    "CubeMeshIds",
    "CylinderInChannel2DIds",
    "make_cube_mesh",
    "make_cylinder_in_channel_2d",
    "make_cylinder_in_channel_3d",
    "extrude_to_3d",
    "graded_distribution",
]

# local corner permutations that mirror an element across its first two axes
_FLIP = {
    ElementType.QUAD: np.array([0, 2, 1, 3]),
    ElementType.HEX: np.array([0, 2, 1, 3, 4, 6, 5, 7]),
}


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


def _fix_orientation(blk: ElementBlock) -> None:
    """Flip elements with a negative Jacobian at the center (2D/3D volume),
    in place (``l3ster_tpu/mesh/gmsh.py:_fix_orientation``)."""
    if blk.element_type not in _FLIP:
        return
    from ..mapping.geometry import geometry_tables
    from .traits import native_dim

    dim = native_dim(blk.element_type)
    _, gd = geometry_tables(blk.element_type, np.zeros((1, dim)))  # (1, dim, n_verts)
    J = np.einsum("qjv,evi->eqij", gd, blk.vertices[:, :, :dim])[:, 0]
    bad = np.linalg.det(J) < 0
    if bad.any():
        perm = _FLIP[blk.element_type]
        blk.nodes[bad] = blk.nodes[bad][:, perm]
        blk.vertices[bad] = blk.vertices[bad][:, perm]


@dataclass(frozen=True)
class CylinderInChannel2DIds:
    """Domain ids matching the reference (CylinderInChannel2D.hpp:10-13)."""

    domain: int = 0
    bottom: int = 1
    top: int = 2
    left: int = 3
    right: int = 4
    cylinder: int = 5


def graded_distribution(a: float, b: float, n: int, q: float = 1.0) -> np.ndarray:
    """n-cell point distribution from a to b with geometric cell-size ratio q."""
    if n < 1:
        raise ValueError("need at least one cell")
    if abs(q - 1.0) < 1e-12:
        return np.linspace(a, b, n + 1)
    w = q ** np.arange(n)
    t = np.concatenate([[0.0], np.cumsum(w)]) / np.sum(w)
    return a + (b - a) * t


def make_cylinder_in_channel_2d(
    r_inner: float = 0.5,
    r_outer: float = 2.0,
    left_offset: float = 10.0,
    right_offset: float = 16.0,
    bottom_offset: float = 15.0,
    top_offset: float = 15.0,
    n_circumf: int = 64,
    n_radial: int = 19,
    n_left: int = 8,
    n_right: int = 50,
    n_bottom: int = 15,
    n_top: int = 15,
    q_radial: float = 1.135,
    q_left: float = 1.3,
    q_right: float = 1.01,
    q_bottom: float = 1.2,
    q_top: float = 1.2,
    ids: CylinderInChannel2DIds = CylinderInChannel2DIds(),
) -> Mesh:
    """Cylinder-in-channel mesh for external-flow problems (Karman vortex
    street), the analog of ``mesh/primitives/CylinderInChannel2D.hpp``.

    Topology: a Cartesian channel grid with a square frame of half-width
    ``r_outer`` carved out around the origin, filled by an O-ring of
    ``n_radial`` graded layers blending the square frame into the cylinder
    circle of radius ``r_inner``.  Boundary domains: channel walls
    (bottom/top), inlet (left), outlet (right), and the cylinder surface.
    """
    if n_circumf % 8:
        raise ValueError("n_circumf must be divisible by 8")
    if not (0 < r_inner < r_outer < min(left_offset, right_offset, bottom_offset, top_offset)):
        raise ValueError("need 0 < r_inner < r_outer < all channel offsets")
    n_side = n_circumf // 4

    # 1D node distributions: refined toward the frame from each channel side
    xs = np.concatenate(
        [
            graded_distribution(-left_offset, -r_outer, n_left, 1.0 / q_left)[:-1],
            np.linspace(-r_outer, r_outer, n_side + 1),
            graded_distribution(r_outer, right_offset, n_right, q_right)[1:],
        ]
    )
    ys = np.concatenate(
        [
            graded_distribution(-bottom_offset, -r_outer, n_bottom, 1.0 / q_bottom)[:-1],
            np.linspace(-r_outer, r_outer, n_side + 1),
            graded_distribution(r_outer, top_offset, n_top, q_top)[1:],
        ]
    )
    nx, ny = len(xs), len(ys)
    ix0, ix1 = n_left, n_left + n_side  # hole cell-index range in x
    iy0, iy1 = n_bottom, n_bottom + n_side

    nid = lambda i, j: j * nx + i
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    coords = np.zeros((nx * ny, 3))
    coords[:, 0] = X.reshape(-1)
    coords[:, 1] = Y.reshape(-1)

    # channel quads: all cells except the carved square
    ii, jj = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1), indexing="xy")
    ii, jj = ii.reshape(-1), jj.reshape(-1)
    in_hole = (ii >= ix0) & (ii < ix1) & (jj >= iy0) & (jj < iy1)
    ii, jj = ii[~in_hole], jj[~in_hole]
    quads = np.stack(
        [nid(ii, jj), nid(ii + 1, jj), nid(ii, jj + 1), nid(ii + 1, jj + 1)], axis=1
    ).astype(np.int64)

    # square-frame perimeter nodes, counter-clockwise from corner (-s, -s)
    per = []
    for i in range(ix0, ix1):  # bottom edge, left->right
        per.append(nid(i, iy0))
    for j in range(iy0, iy1):  # right edge, bottom->top
        per.append(nid(ix1, j))
    for i in range(ix1, ix0, -1):  # top edge, right->left
        per.append(nid(i, iy1))
    for j in range(iy1, iy0, -1):  # left edge, top->bottom
        per.append(nid(ix0, j))
    per = np.asarray(per, dtype=np.int64)
    n_per = len(per)  # == 4 * n_side == n_circumf

    # ring layers: blend square perimeter -> cylinder circle (graded toward r_inner)
    t = graded_distribution(0.0, 1.0, n_radial, 1.0 / q_radial)[1:]  # (n_radial,)
    P = coords[per, :2]
    theta = np.arctan2(P[:, 1], P[:, 0])
    C = r_inner * np.stack([np.cos(theta), np.sin(theta)], axis=1)
    ring_nodes = np.empty((n_radial, n_per), dtype=np.int64)
    new_coords = []
    base = nx * ny
    for L in range(n_radial):
        pts = (1.0 - t[L]) * P + t[L] * C
        ring_nodes[L] = base + L * n_per + np.arange(n_per)
        new_coords.append(pts)
    new_xyz = np.zeros((n_radial * n_per, 3))
    new_xyz[:, :2] = np.concatenate(new_coords)
    coords = np.concatenate([coords, new_xyz])

    layers = np.concatenate([per[None, :], ring_nodes], axis=0)  # (n_radial+1, n_per)
    k = np.arange(n_per)
    kp = (k + 1) % n_per
    ring_quads = []
    for L in range(n_radial):
        a, b = layers[L], layers[L + 1]
        ring_quads.append(np.stack([a[k], a[kp], b[k], b[kp]], axis=1))
    ring_quads = np.concatenate(ring_quads).astype(np.int64)

    all_quads = np.concatenate([quads, ring_quads])

    # drop unused nodes (hole interior), renumber
    used = np.zeros(len(coords), dtype=bool)
    used[all_quads.reshape(-1)] = True
    renum = np.cumsum(used) - 1
    coords = coords[used]
    all_quads = renum[all_quads]

    def line_block(node_ids: np.ndarray) -> ElementBlock:
        nodes = np.stack([node_ids[:-1], node_ids[1:]], axis=1).astype(np.int64)
        verts = np.zeros((len(node_ids) - 1, 2, 3))
        verts[:, 0, :] = coords[node_ids[:-1]]
        verts[:, 1, :] = coords[node_ids[1:]]
        return ElementBlock(ElementType.LINE, 1, nodes, verts)

    bottom_ids = renum[nid(np.arange(nx), 0)]
    top_ids = renum[nid(np.arange(nx), ny - 1)]
    left_ids = renum[nid(0, np.arange(ny))]
    right_ids = renum[nid(nx - 1, np.arange(ny))]
    cyl_loop = renum[np.concatenate([layers[-1], layers[-1][:1]])]

    vol = ElementBlock(ElementType.QUAD, 1, all_quads, coords[all_quads])
    _fix_orientation(vol)

    domains = {
        ids.domain: [vol],
        ids.bottom: [line_block(bottom_ids)],
        ids.top: [line_block(top_ids)],
        ids.left: [line_block(left_ids)],
        ids.right: [line_block(right_ids)],
        ids.cylinder: [line_block(cyl_loop)],
    }
    return Mesh(
        dim=2,
        n_nodes=len(coords),
        node_coords=coords,
        domains=domains,
        boundary_ids=(ids.bottom, ids.top, ids.left, ids.right, ids.cylinder),
    )


def extrude_to_3d(
    mesh2d: Mesh,
    distz,
    back_id: int | None = None,
    front_id: int | None = None,
) -> Mesh:
    """Extrude a 2D quad mesh into 3D hexes along z.

    Every 2D volume domain becomes a hex domain with the same id; every 2D
    boundary (line) domain becomes a quad wall with the same id; optional
    back/front cap boundaries are added at z = distz[0] / distz[-1].  This is
    the generalization behind the CylinderInChannel3D-style primitives
    (``mesh/primitives/CylinderInChannel3D.hpp``).
    """
    distz = _as_dist(distz)
    if mesh2d.dim != 2:
        raise ValueError("extrude_to_3d expects a 2D mesh")
    if any(blk.order != 1 for _, blk in mesh2d.blocks()):
        raise ValueError("extrude an order-1 mesh, then convert_mesh_to_order")
    n2d = mesh2d.n_nodes
    nz = len(distz)
    coords = np.tile(mesh2d.node_coords, (nz, 1))
    coords[:, 2] = np.repeat(distz, n2d)

    existing = set(mesh2d.domains)
    if back_id is None:
        back_id = max(existing) + 1
    if front_id is None:
        front_id = max(existing | {back_id}) + 1

    domains: dict[int, list[ElementBlock]] = {}
    boundary_ids = list(mesh2d.boundary_ids)

    for did, blk in mesh2d.blocks():
        layers_lo = blk.nodes[None, :, :] + (np.arange(nz - 1) * n2d)[:, None, None]
        layers_hi = layers_lo + n2d
        nodes = np.concatenate([layers_lo, layers_hi], axis=2).reshape(
            -1, 2 * blk.nodes.shape[1]
        )
        if blk.element_type == ElementType.QUAD and did not in mesh2d.boundary_ids:
            et = ElementType.HEX
        elif blk.element_type == ElementType.LINE and did in mesh2d.boundary_ids:
            et = ElementType.QUAD
        else:
            raise ValueError(f"cannot extrude {blk.element_type.name} in domain {did}")
        new = ElementBlock(et, 1, nodes.astype(np.int64), coords[nodes])
        domains.setdefault(did, []).append(new)

    # caps from the 2D volume quads
    for did, blk in mesh2d.blocks():
        if did in mesh2d.boundary_ids:
            continue
        back = ElementBlock(ElementType.QUAD, 1, blk.nodes.copy(), coords[blk.nodes])
        top_nodes = blk.nodes + (nz - 1) * n2d
        front = ElementBlock(ElementType.QUAD, 1, top_nodes, coords[top_nodes])
        domains.setdefault(back_id, []).append(back)
        domains.setdefault(front_id, []).append(front)
    boundary_ids += [back_id, front_id]

    return Mesh(
        dim=3,
        n_nodes=n2d * nz,
        node_coords=coords,
        domains=domains,
        boundary_ids=tuple(boundary_ids),
    )


def make_cylinder_in_channel_3d(
    distz=None,
    back_id: int = 6,
    front_id: int = 7,
    **kwargs,
) -> Mesh:
    """3D cylinder-in-channel: the 2D O-ring mesh extruded along z
    (``mesh/primitives/CylinderInChannel3D.hpp`` analog).  Boundary ids:
    2D ids (bottom=1, top=2, left=3, right=4, cylinder=5) + back/front caps."""
    distz = np.linspace(-2.0, 2.0, 5) if distz is None else np.asarray(distz, float)
    m2 = make_cylinder_in_channel_2d(**kwargs)
    return extrude_to_3d(m2, distz, back_id=back_id, front_id=front_id)
