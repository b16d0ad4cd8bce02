"""Global DOF management.

Analog of ``dofs/NodeToDofMap.hpp`` + ``dofs/NodeCondensation.hpp``: a
node-major global numbering of the active (node, component) pairs declared by
the ProblemDefinition.  Periodic BCs alias the image node's dofs to its
source node; static condensation excludes element-interior nodes from the
global numbering (they are recovered per element after the solve).

Everything here is one-shot host-side numpy; the resulting index arrays are
the static gather/scatter maps baked into the traced compute path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..common.problem import ProblemDefinition
from ..mesh.core import Mesh

__all__ = ["DofMap", "build_dof_map"]


@dataclass
class DofMap:
    """node_dof[node, k] = global dof id of component k at node, or -1."""

    node_dof: np.ndarray  # (n_nodes, max_dofs) int64
    n_dofs: int
    max_dofs_per_node: int
    # flat (node*max_dofs + k) -> representative flat index (identity unless
    # that component is periodically aliased); per-component because the
    # reference aliases only the BC's ``dof_inds`` (bcs/BCDefinition.hpp:95-103)
    representative: np.ndarray  # (n_nodes * max_dofs,) int64

    def element_dofs(self, nodes: np.ndarray, dof_inds) -> np.ndarray:
        """Gather (n_elem, n_nodes, len(dof_inds)) global dofs for element nodes."""
        dof_inds = np.asarray(list(dof_inds), dtype=np.int64)
        return self.node_dof[nodes][:, :, dof_inds]


def _resolve_representatives(n_nodes: int, pairs: np.ndarray) -> np.ndarray:
    """Union-find collapse of periodic (src, dest) node identifications."""
    parent = np.arange(n_nodes, dtype=np.int64)

    def find(i: int) -> int:
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:
            parent[i], i = root, parent[i]
        return root

    for src, dest in pairs:
        rs, rd = find(int(src)), find(int(dest))
        if rs != rd:
            # keep the smaller id as representative for determinism
            lo, hi = (rs, rd) if rs < rd else (rd, rs)
            parent[hi] = lo
    return np.array([find(int(i)) for i in range(n_nodes)], dtype=np.int64)


def build_dof_map(
    mesh: Mesh,
    problem: ProblemDefinition,
    periodic_pairs: np.ndarray | None = None,
    condensed_nodes: np.ndarray | None = None,
    periodic_dof_masks: np.ndarray | None = None,
) -> DofMap:
    """Number the active DOFs node-major.

    periodic_pairs: (n_pairs, 2) node-id identifications (src, dest).
    periodic_dof_masks: (n_pairs, max_dofs) bool — which components of each
    pair are aliased (the BC's ``dof_inds``, bcs/BCDefinition.hpp:95-103).
    None aliases every component.
    condensed_nodes: node ids excluded from the global numbering
    (ELEMENT_BOUNDARY static condensation).
    """
    max_dofs = problem.max_dofs_per_node
    n_flat = mesh.n_nodes * max_dofs
    active = np.zeros((mesh.n_nodes, max_dofs), dtype=bool)
    for domain_ids, mask in problem.entries:
        nodes = mesh.nodes_of(domain_ids)
        if len(nodes):
            active[np.ix_(nodes, np.nonzero(mask)[0])] = True

    if periodic_pairs is not None and len(periodic_pairs):
        pp = np.asarray(periodic_pairs, dtype=np.int64)
        if periodic_dof_masks is None:
            masks = np.ones((len(pp), max_dofs), dtype=bool)
        else:
            masks = np.asarray(periodic_dof_masks, dtype=bool)
            if masks.shape != (len(pp), max_dofs):
                raise ValueError("periodic_dof_masks must be (n_pairs, max_dofs)")
        comp = np.arange(max_dofs, dtype=np.int64)[None, :]
        src_flat = (pp[:, 0, None] * max_dofs + comp)[masks]
        dst_flat = (pp[:, 1, None] * max_dofs + comp)[masks]
        rep = _resolve_representatives(n_flat, np.stack([src_flat, dst_flat], axis=1))
        # union activity onto representatives (per component)
        af = active.reshape(-1)
        np.logical_or.at(af, rep, af)
    else:
        rep = np.arange(n_flat, dtype=np.int64)

    ident = np.arange(n_flat, dtype=np.int64)
    numbered_flat = active.reshape(-1).copy()
    numbered_flat[rep != ident] = False  # aliases take the rep's dofs
    numbered = numbered_flat.reshape(mesh.n_nodes, max_dofs)
    if condensed_nodes is not None and len(condensed_nodes):
        numbered[np.asarray(condensed_nodes, dtype=np.int64)] = False

    node_dof = np.full((mesh.n_nodes, max_dofs), -1, dtype=np.int64)
    flat = numbered.reshape(-1)
    ids = np.cumsum(flat) - 1
    node_dof.reshape(-1)[flat] = ids[flat]
    n_dofs = int(flat.sum())

    aliased = np.nonzero(rep != ident)[0]
    if len(aliased):
        nd_flat = node_dof.reshape(-1)
        nd_flat[aliased] = nd_flat[rep[aliased]]
        # an alias may activate a component its representative doesn't have
        # numbered; LSFEM requires matching activity, enforce it:
        bad = active.reshape(-1)[aliased] & (nd_flat[aliased] < 0)
        if bad.any():
            raise ValueError("periodic image node has active dofs its source lacks")

    return DofMap(node_dof=node_dof, n_dofs=n_dofs, max_dofs_per_node=max_dofs, representative=rep)
