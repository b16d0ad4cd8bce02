"""Quadrature generation over reference elements.

Analog of ``quad/Quadrature.hpp`` / ``quad/ReferenceQuadrature.hpp`` /
``quad/GenerateQuadrature.hpp``: a cached 1D Gauss-Legendre rule tensor-
producted to the element's native dimension.  The quadrature order itself
comes from ``common/problem.py:AssemblyOptions.quadrature_order``.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum
from functools import lru_cache

import numpy as np

from ..math.gauss import gauss_legendre
from ..mesh.traits import ElementType, native_dim

__all__ = ["QuadratureType", "Quadrature", "required_quadrature_order", "get_quadrature"]


class QuadratureType(IntEnum):
    GAUSS_LEGENDRE = 0


@dataclass(frozen=True)
class Quadrature:
    """Points (n_qp, dim) and weights (n_qp,) on the reference element [-1,1]^dim."""

    points: np.ndarray
    weights: np.ndarray

    @property
    def size(self) -> int:
        return len(self.weights)

    @property
    def dim(self) -> int:
        return self.points.shape[1]


def required_quadrature_order(order: int, value_order: int = 1, derivative_order: int = 1) -> int:
    """Quadrature order needed to integrate the least-squares products exactly."""
    return 2 * (value_order * order + derivative_order * max(order - 1, 0))


@lru_cache(maxsize=None)
def get_quadrature(
    et: ElementType, q_order: int, q_type: QuadratureType = QuadratureType.GAUSS_LEGENDRE
) -> Quadrature:
    """Tensor-product Gauss rule exact for total 1D degree <= q_order per axis."""
    if q_type != QuadratureType.GAUSS_LEGENDRE:
        raise NotImplementedError(q_type)
    n1 = q_order // 2 + 1
    x1, w1 = gauss_legendre(n1)
    dim = native_dim(et)
    # x fastest ordering, consistent with mesh.traits.node_lattice
    n_qp = n1**dim
    idx = np.arange(n_qp)
    coords = np.stack([x1[(idx // n1**d) % n1] for d in range(dim)], axis=-1)
    weights = np.ones(n_qp, dtype=np.float64)
    for d in range(dim):
        weights *= w1[(idx // n1**d) % n1]
    return Quadrature(points=coords, weights=weights)
