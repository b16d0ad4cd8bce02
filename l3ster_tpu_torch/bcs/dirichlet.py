"""Dirichlet DOF collection.

Analog of ``bcs/GetDirichletDofs.hpp``: resolve the BCDefinition's Dirichlet
declarations (and normalization pins) to a sorted array of global dof ids.
Strong imposition itself is mask-based and lives in the algebraic systems
(the analog of ``bcs/DirichletBC.hpp`` / ``bcs/LocalDirichletBC.hpp``).
"""

from __future__ import annotations

import numpy as np

from ..common.problem import BCDefinition
from ..dofs.dofmap import DofMap
from ..mesh.core import Mesh

__all__ = ["collect_dirichlet_dofs"]


def collect_dirichlet_dofs(mesh: Mesh, dofmap: DofMap, bc_def: BCDefinition | None) -> np.ndarray:
    """Sorted unique global dof ids subject to strong Dirichlet conditions."""
    if bc_def is None:
        return np.empty(0, dtype=np.int64)
    out = []
    for d in bc_def.dirichlet:
        nodes = mesh.boundary_nodes_of(d.boundaries)
        if len(nodes) == 0:
            raise ValueError(f"Dirichlet boundaries {d.boundaries} contain no nodes")
        dofs = dofmap.node_dof[np.ix_(nodes, np.asarray(d.dof_inds, dtype=np.int64))]
        if (dofs < 0).any():
            raise ValueError(
                f"Dirichlet dof indices {d.dof_inds} not active on boundaries {d.boundaries}"
            )
        out.append(dofs.reshape(-1))
    # normalization: pin the dof at one (deterministic: lowest-id) active node
    for k in bc_def.normalized_dofs:
        col = dofmap.node_dof[:, k]
        active = np.nonzero(col >= 0)[0]
        if len(active) == 0:
            raise ValueError(f"normalization dof {k} is active on no node")
        out.append(np.asarray([col[active[0]]], dtype=np.int64))
    if not out:
        return np.empty(0, dtype=np.int64)
    return np.unique(np.concatenate(out))
