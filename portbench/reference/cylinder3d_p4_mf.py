"""Plain reference of ``cylinder3d_p4_mf``: the 3D cylinder in a channel.

The mesh is worked out again from the generator's parameters by the frozen
copy in ``_cylinder_mesh.py``; the GLL nodes of the configuration's order
lie under each hex's trilinear map and are merged where they coincide
(within 1e-8).  Adiabatic and Dirichlet sides come from the boundary ids of
the configuration file.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from ._cylinder_mesh import cylinder_in_channel_3d
from ._diffusion3d import MATCH_TOL, Judge, element_sides, locate_faces, shapes_of, side_nodes
from ._lsfem import element_nodes_xyz, quadrature_points


def merge_nodes(points: np.ndarray, tol: float = MATCH_TOL) -> tuple[np.ndarray, np.ndarray]:
    """(unique points, index of each point's unique point): points within
    ``tol`` of each other are one node."""
    tree = cKDTree(points)
    _, idx = tree.query(points, k=16, distance_upper_bound=tol)
    label = np.where(idx < len(points), idx, len(points)).min(axis=1)
    uniq, inv = np.unique(label, return_inverse=True)
    return points[uniq], inv


def build(cfg: dict, device) -> Judge:
    p = cfg["order"]
    q1 = quadrature_points(cfg)
    verts, hexes, bfaces = cylinder_in_channel_3d(**cfg["mesh"].get("params", {}))
    P = element_nodes_xyz(verts, p)
    coords, inv = merge_nodes(P.reshape(-1, 3))
    conn = inv.reshape(P.shape[:2])
    faces = {}
    for bid in cfg["adiabatic"]:
        el, sd = locate_faces(hexes, bfaces[bid])
        for s in np.unique(sd):
            faces.setdefault(int(s), []).append(el[sd == s])
    faces = {s: np.concatenate(v) for s, v in faces.items()}
    dirichlet = []
    for bid in cfg["dirichlet"]["boundaries"]:
        el, sd = locate_faces(hexes, bfaces[bid])
        for s in np.unique(sd):
            dirichlet.append(conn[el[sd == s]][:, side_nodes(p, int(s))].reshape(-1))
    return Judge(verts, conn, coords, p, q1, faces, np.unique(np.concatenate(dirichlet)), device)


def shapes(cfg: dict) -> dict:
    """Sizes from the mesh's topology: vertices, then the interior GLL nodes
    of its distinct edges, faces and elements."""
    p = cfg["order"]
    _, hexes, _ = cylinder_in_channel_3d(**cfg["mesh"].get("params", {}))
    pairs = [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7), (0, 4), (1, 5), (2, 6), (3, 7)]
    edges = np.sort(np.stack([hexes[:, [a, b]] for a, b in pairs], axis=1).reshape(-1, 2), axis=1)
    n_edges = len(np.unique(edges, axis=0))
    n_faces = len(np.unique(element_sides(hexes).reshape(-1, 4), axis=0))
    n_nodes = len(np.unique(hexes)) + n_edges * (p - 1) + n_faces * (p - 1) ** 2 + len(hexes) * (p - 1) ** 3
    return shapes_of(len(hexes), n_nodes, p, quadrature_points(cfg), unstructured=True)
