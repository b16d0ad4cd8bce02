"""Promotion of an order-1 mesh to order p.

Analog of ``mesh/ConvertMeshToOrder.hpp`` + ``mesh/ElementIntersecting.hpp``:
each element gets a (p+1)^dim GLL lattice of nodes; nodes shared between
neighboring elements (on common vertices / edges / faces) are deduplicated
**combinatorially** by keying every sub-entity on the sorted global ids of its
corner vertices, with an id-based canonical orientation frame so that all
incident elements agree on the parametric position of each shared node.
Fully vectorized numpy over elements (the reference does neighbor-intersection
per element pair).

Node numbering: unique vertices first, then edge-interior nodes grouped per
unique edge, then face-interior per unique face, then volume-interior per
element -- so element-private nodes are contiguous, which the static-
condensation path exploits (cf. ``mesh/LocalMeshView.hpp:13-57``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from .core import ElementBlock, Mesh
from .traits import ElementType, native_dim, node_lattice, reference_node_coords
from ..basis.tables import basis_at_points

__all__ = ["convert_mesh_to_order", "extract_q1_mesh", "lattice_renumber"]


@dataclass(frozen=True)
class _LatticeClassification:
    """Static classification of an element's order-p lattice nodes."""

    # vertex nodes: (lattice_idx, vertex_idx)
    vertices: tuple
    # edge nodes: (lattice_idx, edge_class_idx, t) with t in 1..p-1 from corner a
    edge_nodes: tuple
    # face nodes: (lattice_idx, face_class_idx, u, v) with u, v in 1..p-1
    face_nodes: tuple
    # volume nodes: (lattice_idx, u, v, w)
    volume_nodes: tuple
    # edge classes: (va, vb) vertex indices (va at free-bit 0)
    edge_classes: tuple
    # face classes: (v00, v10, v01, v11) vertex indices in local bit order
    face_classes: tuple


@lru_cache(maxsize=None)
def _classify(et: ElementType, p: int) -> _LatticeClassification:
    dim = native_dim(et)
    lat = node_lattice(et, p)
    vlat = node_lattice(et, 1)

    def vertex_index(bits: dict[int, int]) -> int:
        target = np.array([bits[a] for a in range(dim)])
        return int(np.nonzero(np.all(vlat == target, axis=1))[0][0])

    edge_classes: list[tuple[int, int]] = []
    edge_lookup: dict[tuple, int] = {}
    face_classes: list[tuple[int, int, int, int]] = []
    face_lookup: dict[tuple, int] = {}
    vertices, edge_nodes, face_nodes, volume_nodes = [], [], [], []

    for li, c in enumerate(lat):
        free = [a for a in range(dim) if 0 < c[a] < p]
        fixed_bits = {a: (0 if c[a] == 0 else 1) for a in range(dim) if a not in free}
        k = len(free)
        if k == 0:
            vertices.append((li, vertex_index(fixed_bits)))
        elif k == 1:
            f = free[0]
            va = vertex_index({**fixed_bits, f: 0})
            vb = vertex_index({**fixed_bits, f: 1})
            key = (va, vb)
            if key not in edge_lookup:
                edge_lookup[key] = len(edge_classes)
                edge_classes.append(key)
            edge_nodes.append((li, edge_lookup[key], int(c[f])))
        elif k == 2:
            f0, f1 = free
            corners = tuple(
                vertex_index({**fixed_bits, f0: b0, f1: b1}) for b1 in (0, 1) for b0 in (0, 1)
            )
            if corners not in face_lookup:
                face_lookup[corners] = len(face_classes)
                face_classes.append(corners)
            face_nodes.append((li, face_lookup[corners], int(c[f0]), int(c[f1])))
        else:
            volume_nodes.append((li, int(c[0]), int(c[1]), int(c[2])))

    return _LatticeClassification(
        vertices=tuple(vertices),
        edge_nodes=tuple(edge_nodes),
        face_nodes=tuple(face_nodes),
        volume_nodes=tuple(volume_nodes),
        edge_classes=tuple(edge_classes),
        face_classes=tuple(face_classes),
    )


def convert_mesh_to_order(mesh: Mesh, order: int) -> Mesh:
    """Return a new mesh with every element block promoted to the given order."""
    p = int(order)
    if p < 1:
        raise ValueError("order must be >= 1")
    if p == 1 and all(blk.order == 1 for _, blk in mesh.blocks()):
        return mesh
    if any(blk.order != 1 for _, blk in mesh.blocks()):
        raise ValueError("convert_mesh_to_order expects an order-1 input mesh")

    block_list = mesh.blocks()  # [(domain_id, block)]

    # ---- Pass 1: enumerate unique vertices, edges, faces ----
    all_corner_ids = np.concatenate([blk.nodes.reshape(-1) for _, blk in block_list])
    unique_verts, _ = np.unique(all_corner_ids, return_inverse=True)
    vert_renum = {int(g): i for i, g in enumerate(unique_verts)}
    vmap = np.full(int(unique_verts.max()) + 1, -1, dtype=np.int64)
    vmap[unique_verts] = np.arange(len(unique_verts))

    edge_rows, face_rows = [], []
    for _, blk in block_list:
        cls = _classify(blk.element_type, p)
        E = blk.nodes  # order-1: nodes == corners
        for va, vb in cls.edge_classes:
            pair = np.sort(np.stack([E[:, va], E[:, vb]], axis=1), axis=1)
            edge_rows.append(pair)
        for corners in cls.face_classes:
            quad = np.sort(E[:, list(corners)], axis=1)
            face_rows.append(quad)

    if edge_rows:
        all_edges = np.concatenate(edge_rows, axis=0)
        unique_edges, edge_inv = np.unique(all_edges, axis=0, return_inverse=True)
        n_edges = len(unique_edges)
    else:
        edge_inv = np.empty(0, dtype=np.int64)
        n_edges = 0
    if face_rows:
        all_faces = np.concatenate(face_rows, axis=0)
        unique_faces, face_inv = np.unique(all_faces, axis=0, return_inverse=True)
        n_faces = len(unique_faces)
    else:
        face_inv = np.empty(0, dtype=np.int64)
        n_faces = 0

    n_vol_elems = sum(
        blk.n_elements for _, blk in block_list if native_dim(blk.element_type) == 3
    )
    nV = len(unique_verts)
    base_e = nV
    base_f = base_e + n_edges * (p - 1)
    base_v = base_f + n_faces * (p - 1) ** 2
    n_total = base_v + n_vol_elems * (p - 1) ** 3

    coords = np.zeros((n_total, 3), dtype=np.float64)
    coords[:nV] = mesh.node_coords[unique_verts]

    # ---- Pass 2: build per-block node arrays ----
    edge_cursor = 0
    face_cursor = 0
    vol_cursor = 0
    new_domains: dict[int, list[ElementBlock]] = {}

    for did, blk in block_list:
        et, E, ne = blk.element_type, blk.nodes, blk.n_elements
        cls = _classify(et, p)
        n_lat = (p + 1) ** native_dim(et)
        new_nodes = np.empty((ne, n_lat), dtype=np.int64)

        for li, vi in cls.vertices:
            new_nodes[:, li] = vmap[E[:, vi]]

        # edge uids for this block's edge classes
        n_ec = len(cls.edge_classes)
        blk_edge_uid = edge_inv[edge_cursor : edge_cursor + n_ec * ne].reshape(n_ec, ne)
        edge_cursor += n_ec * ne
        for li, ci, t in cls.edge_nodes:
            va, vb = cls.edge_classes[ci]
            flip = E[:, va] > E[:, vb]
            slot = np.where(flip, p - 1 - t, t - 1)
            new_nodes[:, li] = base_e + blk_edge_uid[ci] * (p - 1) + slot

        n_fc = len(cls.face_classes)
        blk_face_uid = face_inv[face_cursor : face_cursor + n_fc * ne].reshape(n_fc, ne)
        face_cursor += n_fc * ne
        if n_fc:
            # Precompute per face-class canonical frames
            frames = []
            for corners in cls.face_classes:
                g = E[:, list(corners)]  # (ne, 4) in local bit order 00,10,01,11
                o = np.argmin(g, axis=1)
                e0, e1 = o & 1, o >> 1
                n1 = g[np.arange(ne), o ^ 1]  # neighbor along local axis 0
                n2 = g[np.arange(ne), o ^ 2]  # neighbor along local axis 1
                swap = n1 > n2
                frames.append((e0, e1, swap))
            for li, ci, u, v in cls.face_nodes:
                e0, e1, swap = frames[ci]
                uu = np.where(e0 == 0, u, p - u)
                vv = np.where(e1 == 0, v, p - v)
                cu = np.where(swap, vv, uu)
                cv = np.where(swap, uu, vv)
                slot = (cv - 1) * (p - 1) + (cu - 1)
                new_nodes[:, li] = base_f + blk_face_uid[ci] * (p - 1) ** 2 + slot

        if cls.volume_nodes:
            elem_vol_base = base_v + (vol_cursor + np.arange(ne)) * (p - 1) ** 3
            vol_cursor += ne
            for li, u, v, w in cls.volume_nodes:
                slot = (w - 1) * (p - 1) ** 2 + (v - 1) * (p - 1) + (u - 1)
                new_nodes[:, li] = elem_vol_base + slot

        # Node coordinates: Q1 geometric map at the GLL lattice
        W = basis_at_points(et, 1, reference_node_coords(et, p)).values  # (n_lat, n_verts)
        elem_coords = np.einsum("nv,evd->end", W, blk.vertices)
        coords[new_nodes.reshape(-1)] = elem_coords.reshape(-1, 3)

        new_domains.setdefault(did, []).append(
            ElementBlock(et, p, new_nodes, blk.vertices.copy())
        )

    return Mesh(
        dim=mesh.dim,
        n_nodes=n_total,
        node_coords=coords,
        domains=new_domains,
        boundary_ids=mesh.boundary_ids,
    )


def lattice_renumber(mesh: Mesh) -> Mesh:
    """Relabel nodes to lexicographic lattice order when the node set is a
    full axis-aligned tensor grid (every generated Cube/Square mesh).

    With lattice numbering the matrix-free element gather/scatter runs as
    pure slicing (``ops/lattice.py``) instead of TPU gathers, which are
    per-row overhead-bound.  In-place permutation (block identity preserved);
    a silent no-op for meshes that are not tensor grids.
    """
    coords = mesh.node_coords
    dim = mesh.dim
    idxs, sizes = [], []
    for d in range(dim):
        vals = coords[:, d]
        u = np.unique(vals)
        if len(u) > 1:
            tol = max(1e-12, 1e-9 * (u[-1] - u[0]))
            u = u[np.concatenate([[True], np.diff(u) > tol])]
        else:
            tol = 1e-12
        pos = np.clip(np.searchsorted(u, vals), 0, len(u) - 1)
        lo = np.clip(pos - 1, 0, len(u) - 1)
        pos = np.where(np.abs(vals - u[lo]) < np.abs(u[pos] - vals), lo, pos)
        if not np.all(np.abs(u[pos] - vals) <= 10 * tol):
            return mesh
        idxs.append(pos)
        sizes.append(len(u))
    if int(np.prod(sizes)) != mesh.n_nodes:
        return mesh
    new_ids = idxs[0].astype(np.int64)
    stride = sizes[0]
    for d in range(1, dim):
        new_ids = new_ids + stride * idxs[d]
        stride *= sizes[d]
    if len(np.unique(new_ids)) != mesh.n_nodes:
        return mesh
    for blks in mesh.domains.values():
        for b in blks:
            b.nodes = new_ids[b.nodes]
    nc = np.empty_like(coords)
    nc[new_ids] = coords
    mesh.node_coords = nc
    return mesh


def extract_q1_mesh(mesh: Mesh) -> tuple[Mesh, np.ndarray]:
    """The inverse of :func:`convert_mesh_to_order`: the same mesh at order 1.

    Coarse nodes are exactly the corner vertices of the input mesh's
    elements (geometry is Q1 everywhere, so no information is lost).  Every
    block — volume AND boundary facet — is re-expressed on its corner nodes
    with compact renumbering, keeping all domain/boundary ids, so kernels
    registered on the fine mesh replay verbatim on the coarse one.

    Returns ``(q1_mesh, fine_node_ids)`` where ``fine_node_ids[c]`` is the
    fine-mesh node id of coarse node ``c`` (sorted ascending) — the injection
    map used by the unstructured p-multigrid (``solve/pmg.py``) to restrict
    nodal fields.  The reference has no analog (its multilevel story is
    matrix-based Ifpack2/MueLu, ``solve/Ifpack2Preconditioners.hpp:85-192``);
    this is the mesh-side half of the matrix-free p->1 hierarchy.
    """
    parts = [blk.corner_nodes.ravel() for _, blk in mesh.blocks()]
    fine_ids = np.unique(np.concatenate(parts))
    remap = np.full(mesh.n_nodes, -1, dtype=np.int64)
    remap[fine_ids] = np.arange(len(fine_ids), dtype=np.int64)
    domains: dict[int, list[ElementBlock]] = {}
    for did in sorted(mesh.domains):
        domains[did] = [
            ElementBlock(blk.element_type, 1, remap[blk.corner_nodes], blk.vertices)
            for blk in mesh.domains[did]
        ]
    coords = np.asarray(mesh.node_coords)[fine_ids]
    mesh1 = Mesh(mesh.dim, len(fine_ids), coords, domains, boundary_ids=mesh.boundary_ids)
    return mesh1, fine_ids
