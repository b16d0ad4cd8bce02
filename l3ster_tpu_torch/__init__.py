"""l3ster_tpu_torch: the least-squares spectral/hp element framework on PyTorch and CUDA.

A port of ``l3ster_tpu`` (JAX) that runs on an NVIDIA Hopper GPU: users
declare systems of first-order PDEs as pointwise kernels filling operators
``A0, A1..AD`` and source ``f``, supply a high-order tensor-product mesh, and
the framework assembles and solves the least-squares FEM normal equations.
Plain tensor work is PyTorch; the TPU kernels of the JAX package become
hand-written CUDA kernels (``csrc/``), built with ``nvcc`` at first use.

This package imports torch and numpy only.  Entry points take an explicit
``device`` and ``dtype``; systems run on CUDA unless ``device="cpu"`` is
asked for.  ``ROADMAP.md`` lists what is ported so far.
"""

from .algsys.system import MatrixFreeSystem, make_algebraic_system
from .common.enums import CondensationPolicy, LocalEvalStrategy, OperatorEvaluationStrategy
from .common.kernel import (
    BoundaryInput,
    DomainInput,
    KernelParams,
    SpaceTimePoint,
    wrap_boundary_equation_kernel,
    wrap_boundary_residual_kernel,
    wrap_domain_equation_kernel,
    wrap_domain_residual_kernel,
)
from .common.problem import AlgebraicSystemParams, AssemblyOptions, BCDefinition, ProblemDefinition
from .interop import from_lattice_layout, mesh_from_numpy, to_lattice_layout
from .mesh.convert_order import convert_mesh_to_order
from .mesh.core import ElementBlock, Mesh
from .mesh.generators import (
    CubeMeshIds,
    CylinderInChannel2DIds,
    extrude_to_3d,
    graded_distribution,
    make_cube_mesh,
    make_cylinder_in_channel_2d,
    make_cylinder_in_channel_3d,
)
from .mesh.traits import ElementType
from .solve.interface import IterSolveResult, IterSolverOpts
from .solve.krylov import CG
from .solve.precond import Identity, Jacobi

__version__ = "0.1.0"


def generate_mesh(mesh: Mesh, order: int = 1) -> Mesh:
    """Promote a generated order-1 mesh to the requested element order.
    Tensor-grid meshes are relabeled to lattice node order, so the operator
    runs as banded sweeps on the lattice tensor (``ops/lattice_sumfact.py``);
    other meshes keep their numbering and take the gather-based paths."""
    from .mesh.convert_order import lattice_renumber

    return lattice_renumber(convert_mesh_to_order(mesh, order))
