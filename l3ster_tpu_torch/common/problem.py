"""Problem and boundary-condition definitions.

Analogs of ``common/ProblemDefinition.hpp:95-136`` and
``bcs/BCDefinition.hpp:78-124``: runtime descriptions of which DOFs are active
on which domains, and of Dirichlet / periodic / normalization constraints.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["ProblemDefinition", "BCDefinition", "AlgebraicSystemParams", "AssemblyOptions"]

from .enums import CondensationPolicy, LocalEvalStrategy, OperatorEvaluationStrategy


@dataclass(frozen=True)
class AlgebraicSystemParams:
    """Static system configuration (``common/KernelInterface.hpp:22-27``)."""

    eval_strategy: OperatorEvaluationStrategy = OperatorEvaluationStrategy.GLOBAL_ASSEMBLY
    cond_policy: CondensationPolicy = CondensationPolicy.NONE
    n_rhs: int = 1


@dataclass(frozen=True)
class AssemblyOptions:
    """Per-assembly options (``algsys/AssembleLocalSystem.hpp:24-49``).

    ``value_order`` / ``derivative_order`` feed the quadrature-order rule
    QO = 2 * (vo * p + do * (p - 1)); ``eval_strategy`` picks the local
    matrix-free evaluation scheme.

    DELIBERATE DIVERGENCE: the reference defaults ``derivative_order = 0``
    (quadrature order 2p); this framework defaults ``1`` (order 4p-2), an
    accuracy-conservative choice that integrates the derivative products of
    the LSFEM normal equations exactly.  Benchmarks and parity comparisons
    pass ``AssemblyOptions(value_order=1, derivative_order=0)`` to match the
    reference's quadrature cost (see PARITY.md).
    """

    value_order: int = 1
    derivative_order: int = 1
    eval_strategy: LocalEvalStrategy = LocalEvalStrategy.AUTO

    def quadrature_order(self, element_order: int) -> int:
        return 2 * (
            self.value_order * element_order
            + self.derivative_order * max(element_order - 1, 0)
        )


class ProblemDefinition:
    """Which DOFs (of ``max_dofs_per_node``) are active on which domains."""

    def __init__(self, max_dofs_per_node: int, domains=None):
        self.max_dofs_per_node = int(max_dofs_per_node)
        self._entries: list[tuple[tuple[int, ...], np.ndarray]] = []
        if domains is not None:
            self.define(domains)

    def define(self, domain_ids, dof_inds=None) -> "ProblemDefinition":
        """Activate the given DOF indices (all by default) on the domains."""
        mask = np.zeros(self.max_dofs_per_node, dtype=bool)
        if dof_inds is None:
            mask[:] = True
        else:
            mask[np.asarray(list(dof_inds), dtype=np.int64)] = True
        self._entries.append((tuple(int(d) for d in domain_ids), mask))
        return self

    @property
    def entries(self):
        return list(self._entries)

    def domains(self) -> tuple[int, ...]:
        out: list[int] = []
        for ids, _ in self._entries:
            out.extend(ids)
        return tuple(dict.fromkeys(out))

    def active_mask(self, domain_id: int) -> np.ndarray:
        mask = np.zeros(self.max_dofs_per_node, dtype=bool)
        for ids, m in self._entries:
            if domain_id in ids:
                mask |= m
        return mask


@dataclass
class _DirichletDef:
    boundaries: tuple[int, ...]
    dof_inds: tuple[int, ...]


@dataclass
class _PeriodicDef:
    src_boundaries: tuple[int, ...]
    dest_boundaries: tuple[int, ...]
    translation: np.ndarray  # (3,)
    dof_inds: tuple[int, ...]


@dataclass
class BCDefinition:
    """Collected boundary-condition declarations (``bcs/BCDefinition.hpp``)."""

    problem: ProblemDefinition | None = None
    dirichlet: list[_DirichletDef] = field(default_factory=list)
    periodic: list[_PeriodicDef] = field(default_factory=list)
    normalized_dofs: tuple[int, ...] = ()
    periodic_match_tolerance: float = 1e-10

    def define_dirichlet(self, boundaries, dof_inds=None) -> "BCDefinition":
        if dof_inds is None:
            if self.problem is None:
                raise ValueError("dof_inds required when no ProblemDefinition is attached")
            dof_inds = range(self.problem.max_dofs_per_node)
        self.dirichlet.append(
            _DirichletDef(tuple(int(b) for b in boundaries), tuple(int(d) for d in dof_inds))
        )
        return self

    def define_periodic(self, src_boundaries, dest_boundaries, translation, dof_inds=None) -> "BCDefinition":
        if dof_inds is None:
            if self.problem is None:
                raise ValueError("dof_inds required when no ProblemDefinition is attached")
            dof_inds = range(self.problem.max_dofs_per_node)
        t = np.zeros(3)
        t[: len(translation)] = np.asarray(translation, dtype=np.float64)
        self.periodic.append(
            _PeriodicDef(
                tuple(int(b) for b in src_boundaries),
                tuple(int(b) for b in dest_boundaries),
                t,
                tuple(int(d) for d in dof_inds),
            )
        )
        return self

    def normalize(self, dof_inds) -> "BCDefinition":
        """Pin one (arbitrary) node's DOFs to remove a null space
        (pressure-pinning, ``bcs/BCDefinition.hpp:104-114``)."""
        self.normalized_dofs = self.normalized_dofs + tuple(int(d) for d in dof_inds)
        return self

    def set_periodic_match_tolerance(self, tol: float) -> "BCDefinition":
        self.periodic_match_tolerance = float(tol)
        return self
