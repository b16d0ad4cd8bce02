"""Framework-wide enums, analog of ``common/Enums.hpp`` plus the local
evaluation strategy from ``algsys/AssembleLocalSystem.hpp:36-49``."""

from __future__ import annotations

from enum import IntEnum

__all__ = ["CondensationPolicy", "OperatorEvaluationStrategy", "LocalEvalStrategy"]


class CondensationPolicy(IntEnum):
    NONE = 0
    ELEMENT_BOUNDARY = 1


class OperatorEvaluationStrategy(IntEnum):
    GLOBAL_ASSEMBLY = 0
    MATRIX_FREE = 1


class LocalEvalStrategy(IntEnum):
    """How the local (per-element) operator is evaluated in matrix-free apply."""

    AUTO = 0
    DIRECT = 1  # generic per-QP evaluation, any element
    SUM_FACT = 2  # sum-factorized tensor-product sweeps (Quad/Hex)
    SUM_FACT_PALLAS = 3  # fused Pallas TPU kernel (constant-coefficient kernels)
    DENSE_MXU = 4  # dense (Q x n_nodes) basis matmuls: MXU-saturating, any element
    LATTICE_SF = 5  # global banded sum-factorization (structured lattice meshes)
