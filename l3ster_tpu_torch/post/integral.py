"""Domain/boundary integrals and L2 norms of residual kernels
(PyTorch port of ``l3ster_tpu.post.integral``).

Analogs of ``post/Integral.hpp`` and ``post/NormL2.hpp``: quadrature of a
residual kernel over domains (or boundary views, with normals) reduced across
elements.  ``compute_norm_l2`` doubles the quadrature order like the
reference (``post/NormL2.hpp:10-63``).  Both run on ``device``: by default
the device of the field access, else the CUDA device.
"""

from __future__ import annotations

import torch

from ..algsys.local import domain_tables, element_geometry, eval_fields, eval_residual_kernel, side_tables
from ..common.problem import AssemblyOptions
from ..mesh.core import Mesh

__all__ = ["compute_integral", "compute_norm_l2"]


def _integrate(kernel, mesh: Mesh, ids, field_access, time, dtype, device, q_scale, options, square):
    from ..algsys.system import _resolve_device

    if device is None and field_access is not None:
        device = field_access.values.device
    device = _resolve_device(device)
    p = kernel.params
    total = torch.zeros((p.n_equations, p.n_rhs), dtype=dtype, device=device)

    def buckets():
        if kernel.is_boundary:
            for bid in ids:
                views = mesh.boundary_views.get(bid)
                if views is None:
                    raise ValueError(f"domain {bid} is not a boundary of the mesh")
                for bv in views:
                    blk = bv.parent_block
                    qo = q_scale * options.quadrature_order(blk.order)
                    tab = side_tables(blk.element_type, blk.order, bv.side, qo)
                    yield tab, blk.vertices[bv.element_indices], blk.nodes[bv.element_indices]
        else:
            for _, blk in mesh.blocks(ids):
                if blk.dim != p.dimension:
                    raise ValueError("kernel dimension does not match domain elements")
                qo = q_scale * options.quadrature_order(blk.order)
                tab = domain_tables(blk.element_type, blk.order, qo)
                yield tab, blk.vertices, blk.nodes

    found = False
    for tab, verts, nodes in buckets():
        found = True
        geom = element_geometry(tab, torch.as_tensor(verts, dtype=dtype, device=device))
        fv = fd = None
        if field_access is not None:
            fv, fd = eval_fields(tab, geom, field_access.gather(nodes).to(dtype=dtype, device=device))
        vals = eval_residual_kernel(kernel, geom, fv, fd, time)  # (E, Q, n_eq, n_rhs)
        if square:
            vals = vals * vals
        total = total + torch.einsum("eq,eqir->ir", geom.weights, vals)
    if not found:
        raise ValueError(f"no elements found in domains {list(ids)}")
    return total


def compute_integral(
    kernel, mesh: Mesh, ids, field_access=None, time=0.0, dtype=torch.float64, device=None,
    options: AssemblyOptions = AssemblyOptions(),
):
    """Integral of a residual kernel over domains/boundaries; (n_eq, n_rhs)."""
    return _integrate(kernel, mesh, ids, field_access, time, dtype, device, 1, options, square=False)


def compute_norm_l2(
    kernel, mesh: Mesh, ids, field_access=None, time=0.0, dtype=torch.float64, device=None,
    options: AssemblyOptions = AssemblyOptions(),
):
    """Component-wise L2 norm sqrt(integral of kernel^2), doubled quadrature."""
    v = _integrate(kernel, mesh, ids, field_access, time, dtype, device, 2, options, square=True)
    return torch.sqrt(v)
