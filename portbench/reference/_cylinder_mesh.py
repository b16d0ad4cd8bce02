"""Frozen copy of the cylinder-in-channel generator, as geometry only.

A copy of ``make_cylinder_in_channel_2d`` and ``extrude_to_3d`` (the port's
``mesh/generators.py``, itself the analog of the upstream
``mesh/primitives/CylinderInChannel3D.hpp``) kept here so that the
benchmark's reference works the mesh out again from the generator's
parameters, and a later change to the program cannot move it.  It returns
plain arrays: the order-1 hexes' vertex coordinates and, per boundary id,
the boundary quads as sets of four vertex ids.  Element orientation is not
normalized: the reference takes |det J|.
"""

from __future__ import annotations

import numpy as np

DEFAULTS = dict(
    r_inner=0.5, r_outer=2.0, left_offset=10.0, right_offset=16.0, bottom_offset=15.0, top_offset=15.0,
    n_circumf=64, n_radial=19, n_left=8, n_right=50, n_bottom=15, n_top=15,
    q_radial=1.135, q_left=1.3, q_right=1.01, q_bottom=1.2, q_top=1.2,
)
# boundary ids: walls bottom 1, top 2, inlet 3, outlet 4, cylinder 5, caps back 6, front 7
IDS = dict(bottom=1, top=2, left=3, right=4, cylinder=5, back=6, front=7)


def graded_distribution(a: float, b: float, n: int, q: float = 1.0) -> np.ndarray:
    if abs(q - 1.0) < 1e-12:
        return np.linspace(a, b, n + 1)
    w = q ** np.arange(n)
    t = np.concatenate([[0.0], np.cumsum(w)]) / np.sum(w)
    return a + (b - a) * t


def _mesh_2d(p: dict):
    """(coords (n, 2), quads (Q, 4) vertex ids in lattice order, {id: edges (k, 2)})."""
    n_side = p["n_circumf"] // 4
    r_outer, r_inner = p["r_outer"], p["r_inner"]
    xs = np.concatenate([
        graded_distribution(-p["left_offset"], -r_outer, p["n_left"], 1.0 / p["q_left"])[:-1],
        np.linspace(-r_outer, r_outer, n_side + 1),
        graded_distribution(r_outer, p["right_offset"], p["n_right"], p["q_right"])[1:],
    ])
    ys = np.concatenate([
        graded_distribution(-p["bottom_offset"], -r_outer, p["n_bottom"], 1.0 / p["q_bottom"])[:-1],
        np.linspace(-r_outer, r_outer, n_side + 1),
        graded_distribution(r_outer, p["top_offset"], p["n_top"], p["q_top"])[1:],
    ])
    nx, ny = len(xs), len(ys)
    ix0, ix1 = p["n_left"], p["n_left"] + n_side
    iy0, iy1 = p["n_bottom"], p["n_bottom"] + n_side
    nid = lambda i, j: j * nx + i
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    coords = np.stack([X.reshape(-1), Y.reshape(-1)], axis=1)

    ii, jj = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1), indexing="xy")
    ii, jj = ii.reshape(-1), jj.reshape(-1)
    hole = (ii >= ix0) & (ii < ix1) & (jj >= iy0) & (jj < iy1)
    ii, jj = ii[~hole], jj[~hole]
    quads = np.stack([nid(ii, jj), nid(ii + 1, jj), nid(ii, jj + 1), nid(ii + 1, jj + 1)], axis=1)

    per = ([nid(i, iy0) for i in range(ix0, ix1)] + [nid(ix1, j) for j in range(iy0, iy1)]
           + [nid(i, iy1) for i in range(ix1, ix0, -1)] + [nid(ix0, j) for j in range(iy1, iy0, -1)])
    per = np.asarray(per, dtype=np.int64)
    n_per = len(per)
    t = graded_distribution(0.0, 1.0, p["n_radial"], 1.0 / p["q_radial"])[1:]
    P = coords[per]
    theta = np.arctan2(P[:, 1], P[:, 0])
    C = r_inner * np.stack([np.cos(theta), np.sin(theta)], axis=1)
    base = nx * ny
    ring = base + np.arange(p["n_radial"] * n_per).reshape(p["n_radial"], n_per)
    coords = np.concatenate([coords] + [(1.0 - tl) * P + tl * C for tl in t])
    layers = np.concatenate([per[None, :], ring], axis=0)
    k = np.arange(n_per)
    kp = (k + 1) % n_per
    ring_quads = np.concatenate([np.stack([a[k], a[kp], b[k], b[kp]], axis=1) for a, b in zip(layers[:-1], layers[1:])])
    quads = np.concatenate([quads, ring_quads]).astype(np.int64)

    edges = {
        IDS["bottom"]: np.stack([nid(np.arange(nx - 1), 0), nid(np.arange(1, nx), 0)], axis=1),
        IDS["top"]: np.stack([nid(np.arange(nx - 1), ny - 1), nid(np.arange(1, nx), ny - 1)], axis=1),
        IDS["left"]: np.stack([nid(0, np.arange(ny - 1)), nid(0, np.arange(1, ny))], axis=1),
        IDS["right"]: np.stack([nid(nx - 1, np.arange(ny - 1)), nid(nx - 1, np.arange(1, ny))], axis=1),
        IDS["cylinder"]: np.stack([layers[-1], layers[-1][kp]], axis=1),
    }
    return coords, quads, edges


def cylinder_in_channel_3d(distz=None, **params):
    """(verts (E, 8, 3), hex vertex ids (E, 8), {boundary id: quads (k, 4) vertex ids}).

    Hex vertices are in lattice order (x fastest, then y, then z): the 2D
    quad's four vertices at the lower z, then at the upper z."""
    p = dict(DEFAULTS, **params)
    distz = np.linspace(-2.0, 2.0, 5) if distz is None else np.asarray(distz, dtype=np.float64)
    c2, quads, edges = _mesh_2d(p)
    n2, nz = len(c2), len(distz)
    coords = np.concatenate([np.tile(c2, (nz, 1)), np.repeat(distz, n2)[:, None]], axis=1)
    lo = quads[None, :, :] + (np.arange(nz - 1) * n2)[:, None, None]
    hexes = np.concatenate([lo, lo + n2], axis=2).reshape(-1, 8)
    faces = {}
    for bid, e in edges.items():
        lo = e[None, :, :] + (np.arange(nz - 1) * n2)[:, None, None]
        faces[bid] = np.concatenate([lo, lo + n2], axis=2).reshape(-1, 4)
    faces[IDS["back"]] = quads
    faces[IDS["front"]] = quads + (nz - 1) * n2
    return coords[hexes], hexes, faces
