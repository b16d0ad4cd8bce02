"""Domain splitting utilities.

Analog of ``mesh/SplitMesh.hpp``: carve a domain into two by an element-wise
predicate (evaluated on centroids), preserving boundary assignments.  Used
for multi-material problems and interior/border decompositions.  Copied
from ``l3ster_tpu.mesh.split``.
"""

from __future__ import annotations

import numpy as np

from .core import ElementBlock, Mesh

__all__ = ["split_domain"]


def split_domain(mesh: Mesh, domain_id: int, predicate, new_domain_id: int) -> Mesh:
    """Move elements of ``domain_id`` with predicate(centroids)->True into
    ``new_domain_id``; returns a new Mesh sharing the node arrays."""
    if domain_id not in mesh.domains:
        raise ValueError(f"mesh has no domain {domain_id}")
    if new_domain_id in mesh.domains:
        raise ValueError(f"domain {new_domain_id} already exists")
    new_domains: dict[int, list[ElementBlock]] = {}
    moved: list[ElementBlock] = []
    for did in sorted(mesh.domains):
        blocks = mesh.domains[did]
        if did != domain_id:
            new_domains[did] = list(blocks)
            continue
        kept = []
        for blk in blocks:
            centroids = blk.vertices.mean(axis=1)
            sel = np.asarray(predicate(centroids), dtype=bool)
            if sel.ndim != 1 or len(sel) != blk.n_elements:
                raise ValueError("predicate must return a boolean per element")
            if sel.any():
                moved.append(
                    ElementBlock(blk.element_type, blk.order, blk.nodes[sel], blk.vertices[sel])
                )
            if (~sel).any():
                kept.append(
                    ElementBlock(blk.element_type, blk.order, blk.nodes[~sel], blk.vertices[~sel])
                )
        if kept:
            new_domains[domain_id] = kept
    if moved:
        new_domains[new_domain_id] = moved
    return Mesh(
        dim=mesh.dim,
        n_nodes=mesh.n_nodes,
        node_coords=mesh.node_coords,
        domains=new_domains,
        boundary_ids=mesh.boundary_ids,
    )
