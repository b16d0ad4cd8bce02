"""Reference basis-function tables.

Analog of ``basisfun/``: Lagrange tensor-product shape functions at GLL nodes,
evaluated (values + reference-space derivatives) at arbitrary point sets,
memoized per (basis, element type, order, quadrature).  These tables are the
static constants that parameterize the batched element computations; the
reference memoizes them in templated globals
(``basisfun/ReferenceElementBasisAtQuadrature.hpp:10-66``).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum
from functools import lru_cache

import numpy as np

from ..math.gauss import gauss_lobatto
from ..math.lagrange import lagrange_derivatives, lagrange_values
from ..mesh.traits import ElementType, native_dim, node_lattice, side_axis_sign
from ..quadrature.rules import Quadrature, QuadratureType, get_quadrature

__all__ = [
    "BasisType",
    "BasisAtPoints",
    "basis_at_points",
    "basis_at_quadrature",
    "basis_at_side_quadrature",
    "basis_at_nodes",
    "basis_1d",
]


class BasisType(IntEnum):
    LAGRANGE = 0


@dataclass(frozen=True)
class BasisAtPoints:
    """Basis tables at a point set.

    values: (n_pts, n_nodes)         -- N_j(x_i)
    derivatives: (n_pts, dim, n_nodes) -- dN_j/dxi_d (reference space)
    points: (n_pts, dim)             -- the evaluation points (reference space)
    weights: (n_pts,) or None        -- quadrature weights if applicable
    """

    values: np.ndarray
    derivatives: np.ndarray
    points: np.ndarray
    weights: np.ndarray | None = None


@lru_cache(maxsize=None)
def basis_1d(order: int, basis_type: BasisType = BasisType.LAGRANGE):
    """1D node set (GLL) for a given order; returns the node coordinates."""
    if basis_type != BasisType.LAGRANGE:
        raise NotImplementedError(basis_type)
    if order == 0:
        return np.array([0.0])
    nodes, _ = gauss_lobatto(order + 1)
    return nodes


def _tensor_basis(et: ElementType, order: int, pts: np.ndarray, basis_type: BasisType):
    """Tensor-product Lagrange basis values/derivatives at pts (n_pts, dim)."""
    dim = native_dim(et)
    nodes1 = basis_1d(order, basis_type)
    lat = node_lattice(et, order)  # (n_nodes, dim)
    n_pts = pts.shape[0]
    n_nodes = lat.shape[0]
    # Per-axis 1D tables: vals1[d][i, k] = l_k(pts[i, d])
    vals1 = [lagrange_values(nodes1, pts[:, d]) for d in range(dim)]
    ders1 = [lagrange_derivatives(nodes1, pts[:, d]) for d in range(dim)]
    values = np.ones((n_pts, n_nodes), dtype=np.float64)
    for d in range(dim):
        values *= vals1[d][:, lat[:, d]]
    derivatives = np.empty((n_pts, dim, n_nodes), dtype=np.float64)
    for dd in range(dim):
        der = np.ones((n_pts, n_nodes), dtype=np.float64)
        for d in range(dim):
            tab = ders1[d] if d == dd else vals1[d]
            der *= tab[:, lat[:, d]]
        derivatives[:, dd, :] = der
    return values, derivatives


def basis_at_points(
    et: ElementType, order: int, pts: np.ndarray, basis_type: BasisType = BasisType.LAGRANGE
) -> BasisAtPoints:
    pts = np.atleast_2d(np.asarray(pts, dtype=np.float64))
    values, derivatives = _tensor_basis(et, order, pts, basis_type)
    return BasisAtPoints(values=values, derivatives=derivatives, points=pts)


@lru_cache(maxsize=None)
def basis_at_quadrature(
    et: ElementType,
    order: int,
    q_order: int,
    basis_type: BasisType = BasisType.LAGRANGE,
    q_type: QuadratureType = QuadratureType.GAUSS_LEGENDRE,
) -> BasisAtPoints:
    """Basis values/ders at the domain quadrature of the element."""
    quad = get_quadrature(et, q_order, q_type)
    values, derivatives = _tensor_basis(et, order, quad.points, basis_type)
    return BasisAtPoints(values=values, derivatives=derivatives, points=quad.points, weights=quad.weights)


@lru_cache(maxsize=None)
def basis_at_side_quadrature(
    et: ElementType,
    order: int,
    side: int,
    q_order: int,
    basis_type: BasisType = BasisType.LAGRANGE,
    q_type: QuadratureType = QuadratureType.GAUSS_LEGENDRE,
) -> BasisAtPoints:
    """Full-element basis tables at the quadrature of one side.

    The facet quadrature (dimension dim-1) is embedded into the element's
    reference space at the side's fixed coordinate; values/derivatives are
    those of ALL (order+1)^dim element shape functions, enabling boundary
    kernels that use normal derivatives (cf.
    ``basisfun/ReferenceElementBasisAtQuadrature.hpp`` boundary variant).
    Facet coordinates are the remaining reference axes in increasing order.
    """
    dim = native_dim(et)
    axis, sign = side_axis_sign(et, side)
    if dim == 1:
        fpts = np.zeros((1, 0))
        fwts = np.ones(1)
    else:
        facet_et = ElementType.LINE if dim == 2 else ElementType.QUAD
        fquad = get_quadrature(facet_et, q_order, q_type)
        fpts, fwts = fquad.points, fquad.weights
    n_qp = fpts.shape[0]
    pts = np.empty((n_qp, dim), dtype=np.float64)
    other_axes = [a for a in range(dim) if a != axis]
    for i, a in enumerate(other_axes):
        pts[:, a] = fpts[:, i]
    pts[:, axis] = float(sign)
    values, derivatives = _tensor_basis(et, order, pts, basis_type)
    return BasisAtPoints(values=values, derivatives=derivatives, points=pts, weights=fwts)


@lru_cache(maxsize=None)
def basis_at_nodes(et: ElementType, order: int, basis_type: BasisType = BasisType.LAGRANGE) -> BasisAtPoints:
    """Basis tables at the element's own nodal points (values are identity)."""
    from ..mesh.traits import reference_node_coords

    pts = reference_node_coords(et, order)
    values, derivatives = _tensor_basis(et, order, pts, basis_type)
    return BasisAtPoints(values=values, derivatives=derivatives, points=pts)
