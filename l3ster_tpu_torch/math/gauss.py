"""Gauss quadrature rules and orthogonal-polynomial utilities.

TPU-native analog of the reference's ``math/ComputeGaussRule.hpp`` (Golub-Welsch
via symmetric tridiagonal eigensolve), ``math/Legendre.hpp`` and
``math/Lobatto.hpp`` / ``math/LobattoRuleAbsc.hpp``.  All rules are computed
once on the host in float64 with numpy and cached; they parameterize the
static basis/quadrature tables that are baked into traced XLA computations.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = [
    "gauss_legendre",
    "gauss_lobatto",
    "legendre_values",
    "golub_welsch",
]


def golub_welsch(alpha: np.ndarray, beta: np.ndarray, mu0: float) -> tuple[np.ndarray, np.ndarray]:
    """Nodes/weights of a Gauss rule from the 3-term recurrence coefficients.

    ``alpha`` are the diagonal and ``beta`` the off-diagonal entries of the
    (orthonormal) Jacobi matrix; ``mu0`` is the total mass of the weight
    function.  Mirrors the reference's eigensolver-based computation
    (``math/ComputeGaussRule.hpp:26-46``).
    """
    n = len(alpha)
    J = np.zeros((n, n), dtype=np.float64)
    J[np.diag_indices(n)] = alpha
    if n > 1:
        idx = np.arange(n - 1)
        J[idx, idx + 1] = beta
        J[idx + 1, idx] = beta
    nodes, vecs = np.linalg.eigh(J)
    weights = mu0 * vecs[0, :] ** 2
    return nodes, weights


@lru_cache(maxsize=None)
def gauss_legendre(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Legendre rule on [-1, 1]; exact for degree <= 2n-1."""
    if n < 1:
        raise ValueError("Gauss-Legendre rule needs at least one point")
    k = np.arange(1, n, dtype=np.float64)
    beta = k / np.sqrt(4.0 * k * k - 1.0)
    nodes, weights = golub_welsch(np.zeros(n), beta, 2.0)
    # Symmetrize to kill eigensolver noise
    nodes = 0.5 * (nodes - nodes[::-1])
    weights = 0.5 * (weights + weights[::-1])
    return nodes, weights


def legendre_values(n: int, x: np.ndarray) -> np.ndarray:
    """Values of Legendre polynomials P_0..P_n at points x, shape (n+1, len(x))."""
    x = np.asarray(x, dtype=np.float64)
    vals = np.empty((n + 1,) + x.shape, dtype=np.float64)
    vals[0] = 1.0
    if n >= 1:
        vals[1] = x
    for k in range(1, n):
        vals[k + 1] = ((2 * k + 1) * x * vals[k] - k * vals[k - 1]) / (k + 1)
    return vals


@lru_cache(maxsize=None)
def gauss_lobatto(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Lobatto-Legendre rule on [-1, 1] including the endpoints.

    Interior points are the roots of P'_{n-1}, obtained as the Gauss points of
    the Jacobi(1,1) weight; weights are w_i = 2 / (n (n-1) P_{n-1}(x_i)^2).
    These abscissae are the high-order node locations (the analog of the
    reference's ``math/LobattoRuleAbsc.hpp``).
    """
    if n < 2:
        raise ValueError("Gauss-Lobatto rule needs at least two points")
    if n == 2:
        nodes = np.array([-1.0, 1.0])
    else:
        m = n - 2  # number of interior points = roots of Jacobi(1,1)_{m}
        k = np.arange(1, m, dtype=np.float64)
        # Orthonormal Jacobi(1,1) (ultraspherical lambda=3/2) recurrence:
        beta = np.sqrt(k * (k + 2.0) / ((2.0 * k + 1.0) * (2.0 * k + 3.0)))
        interior, _ = golub_welsch(np.zeros(m), beta, 4.0 / 3.0)
        nodes = np.concatenate([[-1.0], interior, [1.0]])
    nodes = 0.5 * (nodes - nodes[::-1])
    p = legendre_values(n - 1, nodes)[n - 1]
    weights = 2.0 / (n * (n - 1) * p * p)
    return nodes, weights
