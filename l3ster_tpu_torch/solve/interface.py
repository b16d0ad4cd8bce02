"""Solver interface types (PyTorch port of ``l3ster_tpu.solve.interface``)."""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["IterSolverOpts", "IterSolveResult"]


@dataclass(frozen=True)
class IterSolverOpts:
    """Options for iterative solvers (``solve/SolverInterface.hpp:26-37``).

    ``residual_scaling``: what normalizes the convergence residual —
    "rhs" (norm of b, the default), "initial" (norm of the initial
    residual), or "none" (absolute).  ``verbosity``: 0 silent, 1 prints a
    summary line per solve.
    """

    tol: float = 1e-10
    max_iters: int = 5000
    verbosity: int = 0
    residual_scaling: str = "rhs"


@dataclass(frozen=True)
class IterSolveResult:
    """Outcome of an iterative solve (``solve/SolverInterface.hpp:39-43``).

    ``converged``: the achieved residual met the requested tolerance.
    ``capped``: the solve stopped because it hit ``max_iters`` WITHOUT
    converging; iterative solvers then emit a ``RuntimeWarning``.
    """

    tol: float  # achieved relative residual (max over right-hand sides)
    num_iters: int
    converged: bool = True
    capped: bool = False
