"""Element types and compile-time traits.

TPU-native analog of ``mesh/ElementType.hpp`` + ``mesh/ElementTraits.hpp``:
only tensor-product elements (Line / Quad / Hex) exist, and every per-(type,
order) property is a small numpy index table computed once on the host.  The
reference encodes these as constexpr template tables; here they are cached
functions whose outputs become static constants of traced XLA programs.

Local node ordering convention (matches the reference's generators, e.g.
``mesh/primitives/SquareMesh.hpp:36-41``): lattice nodes ordered
lexicographically with x fastest, i.e. node index = ix + (p+1)*iy + (p+1)^2*iz.
Corner vertices use the same convention at order 1.  The reference element is
[-1, 1]^dim with high-order nodes at Gauss-Lobatto-Legendre abscissae.
"""

from __future__ import annotations

from enum import IntEnum
from functools import lru_cache

import numpy as np

from ..math.gauss import gauss_lobatto

__all__ = [
    "ElementType",
    "native_dim",
    "n_verts",
    "n_sides",
    "n_nodes",
    "node_lattice",
    "corner_lattice_indices",
    "side_axis_sign",
    "side_node_indices",
    "side_corner_indices",
    "side_facet_type",
    "internal_node_indices",
    "boundary_node_indices",
    "reference_node_coords",
]


class ElementType(IntEnum):
    LINE = 0
    QUAD = 1
    HEX = 2


_DIM = {ElementType.LINE: 1, ElementType.QUAD: 2, ElementType.HEX: 3}


def native_dim(et: ElementType) -> int:
    return _DIM[et]


def n_verts(et: ElementType) -> int:
    return 2 ** native_dim(et)


def n_sides(et: ElementType) -> int:
    return 2 * native_dim(et)


def n_nodes(et: ElementType, order: int) -> int:
    return (order + 1) ** native_dim(et)


@lru_cache(maxsize=None)
def node_lattice(et: ElementType, order: int) -> np.ndarray:
    """Integer lattice coordinates of the local nodes, shape (n_nodes, dim)."""
    dim = native_dim(et)
    p1 = order + 1
    idx = np.arange(p1**dim)
    return np.stack([(idx // p1**d) % p1 for d in range(dim)], axis=-1)


@lru_cache(maxsize=None)
def corner_lattice_indices(et: ElementType, order: int) -> np.ndarray:
    """Local node indices of the 2^dim corner vertices, in vertex order."""
    lat = node_lattice(et, order)
    dim = native_dim(et)
    corners = node_lattice(et, 1) * order  # vertex lattice coords scaled to order
    idx = []
    for c in corners:
        match = np.all(lat == c, axis=1).nonzero()[0]
        idx.append(match[0])
    return np.asarray(idx, dtype=np.int64)


def side_axis_sign(et: ElementType, side: int) -> tuple[int, int]:
    """(axis, sign) of a side: sides 2a / 2a+1 are the faces at axis a = -1 / +1."""
    if side < 0 or side >= n_sides(et):
        raise ValueError(f"element {et} has no side {side}")
    return side // 2, (-1 if side % 2 == 0 else 1)


def side_facet_type(et: ElementType) -> ElementType | None:
    """Element type of a facet (one dimension down); None for Line."""
    if et == ElementType.HEX:
        return ElementType.QUAD
    if et == ElementType.QUAD:
        return ElementType.LINE
    return None


@lru_cache(maxsize=None)
def side_node_indices(et: ElementType, order: int, side: int) -> np.ndarray:
    """Local node indices on a side, ordered lexicographically in the facet's
    own frame (remaining axes in increasing order, first one fastest)."""
    lat = node_lattice(et, order)
    axis, sign = side_axis_sign(et, side)
    val = 0 if sign < 0 else order
    on_side = np.nonzero(lat[:, axis] == val)[0]
    other_axes = [a for a in range(native_dim(et)) if a != axis]
    if other_axes:
        # np.lexsort: last key is primary -> first facet axis varies fastest
        keys = tuple(lat[on_side, a] for a in other_axes)
        on_side = on_side[np.lexsort(keys)]
    return on_side.astype(np.int64)


@lru_cache(maxsize=None)
def side_corner_indices(et: ElementType, side: int) -> np.ndarray:
    """Vertex indices (into the element's corner array) lying on a side."""
    side_nodes = side_node_indices(et, 1, side)
    return side_nodes  # at order 1 local node index == vertex index


@lru_cache(maxsize=None)
def internal_node_indices(et: ElementType, order: int) -> np.ndarray:
    """Local nodes strictly inside the element (never shared between elements);
    the condensable set of the ElementBoundary policy
    (``mesh/ElementTraits.hpp:63-141`` internal_node_inds)."""
    lat = node_lattice(et, order)
    inside = np.all((lat > 0) & (lat < order), axis=1)
    return np.nonzero(inside)[0].astype(np.int64)


@lru_cache(maxsize=None)
def boundary_node_indices(et: ElementType, order: int) -> np.ndarray:
    """Local nodes on the element's boundary (complement of the internal set)."""
    lat = node_lattice(et, order)
    inside = np.all((lat > 0) & (lat < order), axis=1)
    return np.nonzero(~inside)[0].astype(np.int64)


@lru_cache(maxsize=None)
def reference_node_coords(et: ElementType, order: int) -> np.ndarray:
    """Reference coordinates of the local nodes (GLL spacing), shape (n_nodes, dim)."""
    gll, _ = gauss_lobatto(order + 1) if order >= 1 else (np.array([0.0]), None)
    lat = node_lattice(et, order)
    return gll[lat]
