"""Evaluation of residual kernels at nodal points
(PyTorch port of ``l3ster_tpu.algsys.values_at_nodes``).

Analog of ``algsys/ComputeValuesAtNodes.hpp:211-380``: evaluate a (domain or
boundary) residual kernel at the nodes of the selected domains or boundary
views (boundaries with outward normals from the parent element map), with
fields if a FieldAccess is given, scatter-add into node arrays with
contribution counting, and average at shared nodes.  Used for Dirichlet
values, initial conditions and ``SolutionManager.set_fields_from_kernel``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..mesh.core import Mesh
from ..mesh.traits import side_node_indices
from .local import element_geometry, eval_fields, eval_residual_kernel, node_tables

__all__ = ["compute_values_at_nodes", "compute_boundary_values_at_nodes"]


def _scatter_average(node_ids_list, vals_list, n_nodes, n_eq, n_rhs, dtype, device):
    acc = torch.zeros((n_nodes, n_eq, n_rhs), dtype=dtype, device=device)
    cnt = torch.zeros((n_nodes,), dtype=dtype, device=device)
    for node_ids, vals in zip(node_ids_list, vals_list):
        flat = torch.as_tensor(node_ids.reshape(-1), device=device)
        acc.index_add_(0, flat, vals.reshape(-1, n_eq, n_rhs))
        cnt.index_add_(0, flat, torch.ones(flat.shape, dtype=dtype, device=device))
    mask = cnt > 0
    avg = acc / torch.where(mask, cnt, torch.ones_like(cnt))[:, None, None]
    return avg, mask


def _evaluate(kernel, tab, verts, nodes, field_access, time, dtype, device):
    geom = element_geometry(
        tab, torch.as_tensor(verts, dtype=dtype, device=device), with_phys_ders=field_access is not None
    )
    fv = fd = None
    if field_access is not None:
        fv, fd = eval_fields(tab, geom, field_access.gather(nodes).to(dtype=dtype, device=device))
    return eval_residual_kernel(kernel, geom, fv, fd, time)


def compute_values_at_nodes(
    kernel, mesh: Mesh, domain_ids, field_access=None, time=0.0, dtype=torch.float64, device=None
):
    """Domain variant: the kernel at the nodes of each element.

    Returns (values (n_nodes, n_eq, n_rhs), mask (n_nodes,) bool) on
    ``device``: the CUDA device unless the caller names one (without CUDA,
    no device raises; pass ``device="cpu"`` for the CPU).
    """
    from .system import _resolve_device

    if kernel.is_boundary:
        return compute_boundary_values_at_nodes(kernel, mesh, domain_ids, field_access, time, dtype, device)
    device = _resolve_device(device)
    p = kernel.params
    ids_list, vals_list = [], []
    for _, blk in mesh.blocks(domain_ids):
        tab = node_tables(blk.element_type, blk.order)
        vals_list.append(_evaluate(kernel, tab, blk.vertices, blk.nodes, field_access, time, dtype, device))
        ids_list.append(blk.nodes)
    if not ids_list:
        raise ValueError(f"no elements found in domains {list(domain_ids)}")
    return _scatter_average(ids_list, vals_list, mesh.n_nodes, p.n_equations, p.n_rhs, dtype, device)


def compute_boundary_values_at_nodes(
    kernel, mesh: Mesh, boundary_ids, field_access=None, time=0.0, dtype=torch.float64, device=None
):
    """Boundary variant: the kernel at the nodes lying on each boundary side.

    Returns (values (n_nodes, n_eq, n_rhs), mask (n_nodes,) bool) on
    ``device``: the CUDA device unless the caller names one.
    """
    from .system import _resolve_device

    device = _resolve_device(device)
    p = kernel.params
    ids_list, vals_list = [], []
    for bid in boundary_ids:
        views = mesh.boundary_views.get(bid)
        if views is None:
            raise ValueError(f"domain {bid} is not a boundary of the mesh")
        for bv in views:
            blk = bv.parent_block
            sn = side_node_indices(blk.element_type, blk.order, bv.side)
            tab = _side_node_tables(blk.element_type, blk.order, bv.side)
            nodes = blk.nodes[bv.element_indices]
            vals_list.append(
                _evaluate(kernel, tab, blk.vertices[bv.element_indices], nodes, field_access, time, dtype, device)
            )
            ids_list.append(nodes[:, sn])
    if not ids_list:
        raise ValueError(f"no boundary facets found in {list(boundary_ids)}")
    return _scatter_average(ids_list, vals_list, mesh.n_nodes, p.n_equations, p.n_rhs, dtype, device)


@lru_cache(maxsize=None)
def _side_node_tables(et, order, side):
    """Basis tables of the FULL element at the nodal points of one side,
    marked as boundary tables so normals are produced."""
    from ..basis.tables import basis_at_points
    from ..mapping.geometry import geometry_tables
    from ..mesh.traits import reference_node_coords
    from .local import DomainTables

    sn = side_node_indices(et, order, side)
    pts = reference_node_coords(et, order)[sn]
    b = basis_at_points(et, order, pts)
    gv, gd = geometry_tables(et, pts)
    w = np.ones(len(sn))
    return DomainTables(et, order, b.values, b.derivatives, w, pts, gv, gd, side=side)
