"""Plain reference of ``diffusion3d_p6_mf``: the upstream Diffusion3D cube.

The unit cube cut into ``elements_per_side``^3 equal hexes (the upstream
``benchmarks/Diffusion3D.hpp`` mesh, weak-scaled), GLL nodes of the
configuration's order numbered as a lattice (x fastest), adiabatic sides
back/front (z), bottom/top (y), Dirichlet T on left/right (x), the
upstream ``CubeMesh.hpp`` ids.  Built from the configuration file alone.
"""

from __future__ import annotations

import numpy as np

from ._diffusion3d import Judge, shapes_of
from ._lsfem import gauss_lobatto_nodes, quadrature_points

# CubeMesh.hpp ids: back z-, front z+, bottom y-, top y+, left x-, right x+
_SIDE_OF_ID = {1: 4, 2: 5, 3: 2, 4: 3, 5: 0, 6: 1}


def build(cfg: dict, device) -> Judge:
    ne, p = cfg["mesh"]["elements_per_side"], cfg["order"]
    q1 = quadrature_points(cfg)
    vx = np.linspace(0.0, 1.0, ne + 1)
    n1 = ne * p + 1
    h = vx[1:] - vx[:-1]
    pos = np.concatenate([vx[k] + (gauss_lobatto_nodes(p + 1)[:-1] + 1.0) / 2.0 * h[k] for k in range(ne)] + [vx[-1:]])
    e = np.arange(ne**3)
    ex, ey, ez = e % ne, (e // ne) % ne, e // ne**2
    b = np.arange(8)
    bx, by, bz = b & 1, (b >> 1) & 1, (b >> 2) & 1
    verts = np.stack([vx[ex[:, None] + bx], vx[ey[:, None] + by], vx[ez[:, None] + bz]], axis=-1)
    i = np.arange((p + 1) ** 3)
    ix, iy, iz = i % (p + 1), (i // (p + 1)) % (p + 1), i // (p + 1) ** 2
    conn = (ex[:, None] * p + ix) + n1 * ((ey[:, None] * p + iy) + n1 * (ez[:, None] * p + iz))
    g = np.arange(n1**3)
    coords = np.stack([pos[g % n1], pos[(g // n1) % n1], pos[g // n1**2]], axis=-1)
    lat_e, lat_n = (ex, ey, ez), (g % n1, (g // n1) % n1, g // n1**2)
    faces = {}
    for bid in cfg["adiabatic"]:
        s = _SIDE_OF_ID[bid]
        faces[s] = e[lat_e[s // 2] == (0 if s % 2 == 0 else ne - 1)]
    dirichlet = []
    for bid in cfg["dirichlet"]["boundaries"]:
        s = _SIDE_OF_ID[bid]
        dirichlet.append(g[lat_n[s // 2] == (0 if s % 2 == 0 else n1 - 1)])
    return Judge(verts, conn, coords, p, q1, faces, np.unique(np.concatenate(dirichlet)), device)



def shapes(cfg: dict) -> dict:
    ne, p = cfg["mesh"]["elements_per_side"], cfg["order"]
    out = shapes_of(ne**3, (ne * p + 1) ** 3, p, quadrature_points(cfg), unstructured=False)
    out["elements_per_side"] = ne
    return out
