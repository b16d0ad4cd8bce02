"""General polynomial type: evaluation, calculus, root finding.

Analog of ``math/Polynomial.hpp``: a dense monomial-basis polynomial with
derivative/antiderivative and root extraction via the companion-matrix
eigenproblem (the reference's ``Polynomial::roots``).  Host-side numpy —
polynomials appear in setup paths (quadrature construction, Lobatto nodes),
never inside traced device code.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["Polynomial", "lagrange_from_roots"]


@dataclass(frozen=True)
class Polynomial:
    """coefficients[k] multiplies x**k (ascending order)."""

    coefficients: tuple

    def __post_init__(self):
        object.__setattr__(
            self, "coefficients", tuple(float(c) for c in self.coefficients) or (0.0,)
        )

    @property
    def order(self) -> int:
        return len(self.coefficients) - 1

    def __call__(self, x):
        """Horner evaluation; broadcasts over array input."""
        x = np.asarray(x, dtype=np.float64)
        acc = np.full_like(x, self.coefficients[-1])
        for c in reversed(self.coefficients[:-1]):
            acc = acc * x + c
        return acc

    def derivative(self) -> "Polynomial":
        c = self.coefficients
        if len(c) == 1:
            return Polynomial((0.0,))
        return Polynomial(tuple(k * c[k] for k in range(1, len(c))))

    def antiderivative(self, constant: float = 0.0) -> "Polynomial":
        c = self.coefficients
        return Polynomial((constant,) + tuple(c[k] / (k + 1) for k in range(len(c))))

    def integrate(self, a: float, b: float) -> float:
        F = self.antiderivative()
        return float(F(b) - F(a))

    def roots(self) -> np.ndarray:
        """All complex roots via the companion-matrix eigenproblem
        (``Polynomial::roots``); trailing zero coefficients are trimmed."""
        c = np.asarray(self.coefficients)
        nz = np.nonzero(c)[0]
        if not len(nz) or nz.max() == 0:
            return np.empty(0, dtype=np.complex128)
        c = c[: nz.max() + 1]
        n = len(c) - 1
        comp = np.zeros((n, n))
        comp[1:, :-1] = np.eye(n - 1)
        comp[:, -1] = -np.asarray(c[:-1]) / c[-1]
        return np.linalg.eigvals(comp)

    def real_roots(self, tol: float = 1e-9) -> np.ndarray:
        r = self.roots()
        rr = np.sort(r[np.abs(r.imag) < tol].real)
        return rr

    def __mul__(self, other: "Polynomial") -> "Polynomial":
        return Polynomial(tuple(np.polynomial.polynomial.polymul(
            self.coefficients, other.coefficients
        )))

    def __add__(self, other: "Polynomial") -> "Polynomial":
        return Polynomial(tuple(np.polynomial.polynomial.polyadd(
            self.coefficients, other.coefficients
        )))


def lagrange_from_roots(roots) -> Polynomial:
    """Monic polynomial with the given roots (for Lagrange-basis products)."""
    c = np.array([1.0])
    for r in np.asarray(roots, dtype=np.float64):
        c = np.polynomial.polynomial.polymul(c, np.array([-r, 1.0]))
    return Polynomial(tuple(c))
