"""Lagrange interpolation basis evaluation.

Analog of the reference's ``math/LagrangeInterpolation.hpp`` and the 1D layer
of ``basisfun/ReferenceBasisFunction.hpp``: values and derivatives of the
Lagrange cardinal polynomials through a given node set, evaluated at arbitrary
points.  Host-side numpy in float64 (node counts are tiny, p+1 <= ~20); the
resulting tables are static constants of the traced compute path.
"""

from __future__ import annotations

import numpy as np

__all__ = ["lagrange_values", "lagrange_derivatives", "lagrange_diff_matrix"]


def lagrange_values(nodes: np.ndarray, x: np.ndarray) -> np.ndarray:
    """l_j(x_i) for cardinal polynomials through ``nodes``; shape (len(x), len(nodes))."""
    nodes = np.asarray(nodes, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    n = len(nodes)
    out = np.ones((len(x), n), dtype=np.float64)
    for j in range(n):
        for k in range(n):
            if k != j:
                out[:, j] *= (x - nodes[k]) / (nodes[j] - nodes[k])
    return out


def lagrange_derivatives(nodes: np.ndarray, x: np.ndarray) -> np.ndarray:
    """l_j'(x_i); shape (len(x), len(nodes)).

    Direct product-rule evaluation: l_j'(x) = sum_{m != j} 1/(x_j - x_m)
    * prod_{k != j, m} (x - x_k)/(x_j - x_k).  Exact and stable for the small
    node counts used here.
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    n = len(nodes)
    out = np.zeros((len(x), n), dtype=np.float64)
    for j in range(n):
        for m in range(n):
            if m == j:
                continue
            term = np.full(len(x), 1.0 / (nodes[j] - nodes[m]))
            for k in range(n):
                if k != j and k != m:
                    term *= (x - nodes[k]) / (nodes[j] - nodes[k])
            out[:, j] += term
    return out


def lagrange_diff_matrix(nodes: np.ndarray) -> np.ndarray:
    """Differentiation matrix D with D[i, j] = l_j'(x_i) at the nodes themselves."""
    return lagrange_derivatives(nodes, nodes)
