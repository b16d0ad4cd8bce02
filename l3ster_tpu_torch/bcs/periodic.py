"""Periodic boundary-condition node identification.

Analog of ``bcs/PeriodicBC.hpp`` + ``util/SpatialHashTable.hpp``: nodes on the
source boundaries are matched to nodes on the destination boundaries at
``x + translation`` within a tolerance, producing (src, dest) node pairs whose
DOFs are aliased by the DofMap.  Matching is a host-side numpy grid hash.
Copied from ``l3ster_tpu.bcs.periodic``, so both packages pair the same nodes.
"""

from __future__ import annotations

import numpy as np

from ..common.problem import BCDefinition
from ..mesh.core import Mesh

__all__ = ["match_periodic_nodes"]


def match_periodic_nodes(
    mesh: Mesh, bc_def: BCDefinition | None, max_dofs: int | None = None
) -> np.ndarray | tuple[np.ndarray, np.ndarray]:
    """Return (n_pairs, 2) array of (src_node, dest_node) identifications.

    When ``max_dofs`` is given, also return a (n_pairs, max_dofs) bool mask of
    which components each pair aliases (the BC's ``dof_inds``,
    bcs/BCDefinition.hpp:95-103).
    """
    if bc_def is None or not bc_def.periodic:
        empty = np.empty((0, 2), dtype=np.int64)
        if max_dofs is not None:
            return empty, np.empty((0, max_dofs), dtype=bool)
        return empty
    tol = bc_def.periodic_match_tolerance
    pairs = []
    pair_dof_inds = []
    for p in bc_def.periodic:
        src = mesh.boundary_nodes_of(p.src_boundaries)
        dest = mesh.boundary_nodes_of(p.dest_boundaries)
        if len(src) != len(dest):
            raise ValueError(
                f"periodic boundaries have {len(src)} source vs {len(dest)} destination nodes"
            )
        target = mesh.node_coords[src] + p.translation[None, :]
        dest_coords = mesh.node_coords[dest]
        # grid hash on the destination side
        cell = max(tol * 8.0, 1e-12)
        keys = np.round(dest_coords / cell).astype(np.int64)
        lookup: dict[tuple, list[int]] = {}
        for i, k in enumerate(map(tuple, keys)):
            lookup.setdefault(k, []).append(i)
        tkeys = np.round(target / cell).astype(np.int64)
        for si, tk in enumerate(map(tuple, tkeys)):
            best, best_d = -1, np.inf
            for dk in _neighbor_keys(tk):
                for j in lookup.get(dk, ()):
                    d = np.linalg.norm(dest_coords[j] - target[si])
                    if d < best_d:
                        best, best_d = j, d
            if best < 0 or best_d > tol:
                raise ValueError(
                    f"no periodic match for node {src[si]} at {mesh.node_coords[src[si]]} "
                    f"+ translation (closest miss {best_d:.3e} > tol {tol:.3e})"
                )
            pairs.append((src[si], dest[best]))
            pair_dof_inds.append(p.dof_inds)
    out = np.asarray(pairs, dtype=np.int64)
    if max_dofs is not None:
        masks = np.zeros((len(pairs), max_dofs), dtype=bool)
        for i, inds in enumerate(pair_dof_inds):
            masks[i, list(inds)] = True
        return out, masks
    return out


def _neighbor_keys(k: tuple):
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                yield (k[0] + dx, k[1] + dy, k[2] + dz)
