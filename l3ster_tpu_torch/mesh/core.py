"""Mesh data structures: struct-of-arrays element blocks.

TPU-native re-design of ``mesh/MeshPartition.hpp`` + ``mesh/Domain.hpp`` +
``mesh/Element.hpp``: instead of per-element structs in UniVectors, every
(domain, element type, order) bucket is a dense **ElementBlock** with
``nodes[n_elem, n_nodes]`` connectivity and ``vertices[n_elem, n_verts, 3]``
corner coordinates (geometry is order-1 / multilinear, exactly like the
reference's ``mesh/ElementData.hpp:14-30``).  Batched XLA computations map
over blocks; the reference's compile-time (type, order) template dispatch
becomes a Python loop over blocks at trace time.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .traits import (
    ElementType,
    n_verts,
    native_dim,
    n_sides,
    side_corner_indices,
)

__all__ = ["ElementBlock", "BoundaryView", "Mesh"]


def _match_rows(table: np.ndarray, query: np.ndarray) -> np.ndarray:
    """Index of each query row in table (first match), or -1; (n_query,)."""
    table = np.ascontiguousarray(table, dtype=np.int64)
    query = np.ascontiguousarray(query, dtype=np.int64)
    k = table.shape[1]
    dt = np.dtype([("", np.int64)] * k)
    tv = table.view(dt).reshape(-1)
    qv = query.view(dt).reshape(-1)
    order = np.argsort(tv, kind="stable")
    ts = tv[order]
    pos = np.searchsorted(ts, qv)
    pos_c = np.minimum(pos, len(ts) - 1) if len(ts) else pos
    ok = (pos < len(ts)) & (ts[pos_c] == qv) if len(ts) else np.zeros(len(qv), bool)
    # first occurrence: among equal table rows, argsort(stable) keeps order
    return np.where(ok, order[pos_c], -1)


@dataclass
class ElementBlock:
    """All elements of one (type, order) within one domain; SoA layout."""

    element_type: ElementType
    order: int
    nodes: np.ndarray  # (n_elem, n_nodes) int64, global node ids
    vertices: np.ndarray  # (n_elem, n_verts, 3) float64, corner coords

    @property
    def n_elements(self) -> int:
        return self.nodes.shape[0]

    @property
    def dim(self) -> int:
        return native_dim(self.element_type)

    @property
    def corner_nodes(self) -> np.ndarray:
        """Global ids of the corner (vertex) nodes, shape (n_elem, n_verts)."""
        from .traits import corner_lattice_indices

        return self.nodes[:, corner_lattice_indices(self.element_type, self.order)]

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"ElementBlock({self.element_type.name}, order={self.order}, "
            f"n_elements={self.n_elements})"
        )


@dataclass
class BoundaryView:
    """Facets of one boundary domain realized as (volume element, side) pairs.

    The analog of ``mesh/BoundaryView.hpp``: boundary integration happens on
    the parent volume element restricted to a side, so that boundary kernels
    see full physical-space derivatives of the FE fields.  Bucketed by
    (parent domain, parent block, side) to keep shapes static.
    """

    parent_domain: int
    parent_block: ElementBlock
    side: int
    element_indices: np.ndarray  # (n_facets,) int64 into the parent block


@dataclass
class Mesh:
    """A (possibly distributed-into-later) mesh: domains of element blocks.

    ``domains`` maps domain id -> list of ElementBlocks.  Boundary domains
    hold facet blocks (dimension dim-1); ``boundary_views`` resolves them to
    (parent element, side) buckets once at construction (the analog of the
    reference's BoundaryManager precomputation, ``mesh/MeshPartition.hpp:18-166``).
    """

    dim: int
    n_nodes: int
    node_coords: np.ndarray  # (n_nodes, 3) float64
    domains: dict[int, list[ElementBlock]]
    boundary_ids: tuple[int, ...] = ()
    boundary_views: dict[int, list[BoundaryView]] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self.boundary_ids = tuple(self.boundary_ids)
        if not self.boundary_views and self.boundary_ids:
            self._build_boundary_views()

    # -- queries ------------------------------------------------------------

    def blocks(self, domain_ids=None) -> list[tuple[int, ElementBlock]]:
        """(domain_id, block) pairs for the requested domains (all if None)."""
        ids = sorted(self.domains) if domain_ids is None else list(domain_ids)
        out = []
        for d in ids:
            for blk in self.domains.get(d, []):
                out.append((d, blk))
        return out

    def domain_dim(self, domain_id: int) -> int:
        return max(blk.dim for blk in self.domains[domain_id])

    @property
    def n_elements(self) -> int:
        return sum(blk.n_elements for blks in self.domains.values() for blk in blks)

    def nodes_of(self, domain_ids) -> np.ndarray:
        """Sorted unique global node ids appearing in the given domains."""
        parts = [blk.nodes.reshape(-1) for _, blk in self.blocks(domain_ids)]
        if not parts:
            return np.empty(0, dtype=np.int64)
        return np.unique(np.concatenate(parts))

    def boundary_nodes_of(self, boundary_ids) -> np.ndarray:
        """Sorted unique node ids on the given boundaries (via parent sides)."""
        from .traits import side_node_indices

        parts = []
        for bid in boundary_ids:
            for bv in self.boundary_views.get(bid, []):
                sn = side_node_indices(bv.parent_block.element_type, bv.parent_block.order, bv.side)
                parts.append(bv.parent_block.nodes[bv.element_indices][:, sn].reshape(-1))
        if not parts:
            return np.empty(0, dtype=np.int64)
        return np.unique(np.concatenate(parts))

    # -- boundary resolution --------------------------------------------------

    def _build_boundary_views(self) -> None:
        """Match each boundary facet to a unique (volume element, side).

        Vectorized numpy searchsorted join of sorted facet corner rows against
        the table of all volume-element side corner rows.
        """
        vol_dim = self.dim
        vol_blocks = [
            (did, blk)
            for did, blk in self.blocks()
            if blk.dim == vol_dim and did not in self.boundary_ids
        ]
        rows, meta_b, meta_s, meta_e = [], [], [], []
        for bi, (did, blk) in enumerate(vol_blocks):
            corners = blk.corner_nodes
            for side in range(n_sides(blk.element_type)):
                sc = side_corner_indices(blk.element_type, side)
                rows.append(np.sort(corners[:, sc], axis=1))
                meta_b.append(np.full(blk.n_elements, bi, dtype=np.int64))
                meta_s.append(np.full(blk.n_elements, side, dtype=np.int64))
                meta_e.append(np.arange(blk.n_elements, dtype=np.int64))
        if not rows:
            raise ValueError("mesh has no volume elements to resolve boundaries against")
        table = np.concatenate(rows)
        meta_b = np.concatenate(meta_b)
        meta_s = np.concatenate(meta_s)
        meta_e = np.concatenate(meta_e)

        for bid in self.boundary_ids:
            views = []
            for _, fblk in self.blocks([bid]):
                if fblk.dim != vol_dim - 1:
                    raise ValueError(
                        f"boundary domain {bid} contains {fblk.dim}D elements in a {vol_dim}D mesh"
                    )
                hit = _match_rows(table, np.sort(fblk.corner_nodes, axis=1))
                if (hit < 0).any():
                    raise ValueError(
                        f"boundary facet in domain {bid} matches no volume element side"
                    )
                # group facets by (parent block, side)
                key = meta_b[hit] * 64 + meta_s[hit]
                for k in np.unique(key):
                    sel = key == k
                    bi, side = int(k) // 64, int(k) % 64
                    did, pblk = vol_blocks[bi]
                    views.append(
                        BoundaryView(
                            parent_domain=did,
                            parent_block=pblk,
                            side=side,
                            element_indices=np.sort(meta_e[hit][sel]).astype(np.int64),
                        )
                    )
            views.sort(key=lambda v: (v.parent_domain, v.side))
            self.boundary_views[bid] = views

    def describe(self) -> str:
        lines = [f"Mesh: dim={self.dim}, {self.n_nodes} nodes, {self.n_elements} elements"]
        for did in sorted(self.domains):
            for blk in self.domains[did]:
                tag = " (boundary)" if did in self.boundary_ids else ""
                lines.append(
                    f"  domain {did}{tag}: {blk.n_elements} x {blk.element_type.name} p={blk.order}"
                )
        return "\n".join(lines)
