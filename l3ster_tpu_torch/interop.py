"""Moving the system's state between the JAX package and the port.

An LSFEM system has no learned parameters: its state is the mesh, the
Dirichlet values and the solution vector.  :func:`mesh_from_numpy` rebuilds a
port :class:`~l3ster_tpu_torch.mesh.core.Mesh` from the plain numpy arrays of
a mesh (for instance those of an ``l3ster_tpu`` ``Mesh``),
:func:`solution_manager_from_numpy` a port SolutionManager from nodal field
values (for instance an ``l3ster_tpu`` ``SolutionManager.values``), and the layout
helpers move (n_dofs, n_rhs) vectors between the dof-major layout
(node * n_unk + unknown) and the channel-major lattice layout
(unknown * n_rows + node) that the lattice operator runs on.  Both accept
numpy arrays and torch tensors.
"""

from __future__ import annotations

import numpy as np

from .mesh.core import ElementBlock, Mesh
from .mesh.traits import ElementType

__all__ = ["mesh_from_numpy", "solution_manager_from_numpy", "to_lattice_layout", "from_lattice_layout"]


def mesh_from_numpy(
    dim: int,
    n_nodes: int,
    node_coords: np.ndarray,
    domains: dict,
    boundary_ids=(),
) -> Mesh:
    """A port Mesh from numpy arrays.

    ``domains`` maps a domain id to a list of blocks, each a tuple
    ``(element_type_name, order, nodes (E, n_nodes) int, vertices (E, n_verts, 3))``
    with ``element_type_name`` one of "LINE", "QUAD", "HEX".  Boundary views
    are rebuilt from ``boundary_ids``.
    """
    blocks = {
        int(did): [
            ElementBlock(
                ElementType[name],
                int(order),
                np.array(nodes, dtype=np.int64),
                np.array(verts, dtype=np.float64),
            )
            for name, order, nodes, verts in blks
        ]
        for did, blks in domains.items()
    }
    return Mesh(
        dim=int(dim),
        n_nodes=int(n_nodes),
        node_coords=np.array(node_coords, dtype=np.float64),
        domains=blocks,
        boundary_ids=tuple(int(b) for b in boundary_ids),
    )


def solution_manager_from_numpy(mesh: Mesh, values, dtype=None, device=None):
    """A port SolutionManager on ``mesh`` holding ``values`` (n_nodes, n_slots),
    in ``dtype`` (float64 by default) on ``device`` (CUDA unless named)."""
    import torch

    from .post.solution import SolutionManager

    values = np.asarray(values)
    if values.ndim != 2 or values.shape[0] != mesh.n_nodes:
        raise ValueError(f"values must be (n_nodes={mesh.n_nodes}, n_slots), got {values.shape}")
    sm = SolutionManager(mesh, values.shape[1], dtype=dtype or torch.float64, device=device)
    sm.values = torch.as_tensor(values, dtype=sm.dtype, device=sm.device).clone()
    return sm


def _relayout(v, a: int, b: int):
    v2 = v[:, None] if v.ndim == 1 else v
    if v2.shape[0] % (a * b):
        raise ValueError(f"vector of {v2.shape[0]} rows does not split into ({a}, {b})")
    out = v2.reshape(a, b, v2.shape[1]).swapaxes(0, 1).reshape(v2.shape)
    return out[:, 0] if v.ndim == 1 else out


def to_lattice_layout(v, n_unk: int):
    """dof-major (node*n_unk+u) -> channel-major (u*n_rows+node) rows."""
    return _relayout(v, v.shape[0] // n_unk, n_unk)


def from_lattice_layout(v, n_unk: int):
    """Inverse of :func:`to_lattice_layout`."""
    return _relayout(v, n_unk, v.shape[0] // n_unk)
