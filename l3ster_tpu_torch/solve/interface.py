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
    summary line per solve, 2 also one line per iteration (per cycle for
    GMRES), which waits for the device each time.

    ``chunk``: 0 (default) runs the solve as one loop.  ``chunk=k`` runs at
    most k iterations at a time and warm-restarts from the current iterate
    until ``tol`` or ``max_iters``, the analog of Belos' outer ``restarts``
    (``solve/SolverInterface.hpp:26-37``); for CG each restart drops the
    conjugate direction (restarted CG: slightly more iterations), and the
    last chunk may overshoot ``max_iters`` by at most ``chunk - 1``.
    Incompatible with ``residual_scaling="initial"``.  ``restart`` is the
    GMRES cycle length.
    """

    tol: float = 1e-10
    max_iters: int = 5000
    restart: int = 50  # GMRES cycle length
    verbosity: int = 0
    residual_scaling: str = "rhs"
    chunk: int = 0  # >0: at most this many iterations before a warm restart


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
