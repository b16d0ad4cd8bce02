"""The port's assembled system against the JAX package, in f64 on the CPU.

Local LSFEM matrices (``local_system``) at p = 1-3 on a distorted 2^3-hex
cube, the host-built CSR structure, the assembled values, diagonal and
Dirichlet-eliminated CSR of the bench kernel (with a source) at p = 2, the
assembled apply against the port's own matrix-free apply, CG + Jacobi on the
assembled system, the factory's default, and the line and square
generators.  One mesh feeds both packages (``_port_mesh``).
"""

import numpy as np
import pytest
import torch

import l3ster_tpu as lt
import l3ster_tpu_torch as lp
from bench import _adiabatic_3d
from tests.test_torch_system import _diffusion_src, _port_mesh, _rel, jax_run
from tests.torch_reference_fixtures import fast_reference_compiles, per_test_limit, xla_optimizations  # noqa: F401 (fixtures)

TOL = 1e-12  # K, F, data, diagonal and eliminated CSR, relative to max |reference|


def _distorted_cube(order):
    """A 2^3-hex cube with uneven spacing along each axis."""
    return lt.generate_mesh(
        lt.make_cube_mesh([0.0, 0.4, 1.0], [0.0, 0.55, 1.1], [0.0, 0.3, 0.8]), order=order
    )


def _build(pkg, mesh, strategy):
    problem = pkg.ProblemDefinition(4, [0])
    bcs = pkg.BCDefinition(problem)
    bcs.define_dirichlet([5, 6], [0])
    params = pkg.AlgebraicSystemParams(eval_strategy=strategy)
    kd = pkg.wrap_domain_equation_kernel(_diffusion_src, pkg.KernelParams(3, 7, 4))
    kn = pkg.wrap_boundary_equation_kernel(_adiabatic_3d, pkg.KernelParams(3, 1, 4))
    if pkg is lt:
        system = lt.make_algebraic_system(mesh, problem, bcs, params)
    else:
        system = lp.make_algebraic_system(
            _port_mesh(mesh), problem, bcs, params, dtype=torch.float64, device="cpu"
        )
    system.set_dirichlet_bc_values([0.0], [5], [0])
    system.set_dirichlet_bc_values([1.0], [6], [0])
    system.begin_assembly()
    system.assemble_problem(kd, [0])
    system.assemble_problem(kn, [1, 2, 3, 4])
    system.end_assembly()
    return system


@pytest.fixture(scope="module")
def asm_pair():
    """The p=2 assembled system in both packages, and the port's matrix-free one."""
    mesh = _distorted_cube(2)
    G = lt.OperatorEvaluationStrategy.GLOBAL_ASSEMBLY
    sj, sp = _build(lt, mesh, G), _build(lp, mesh, lp.OperatorEvaluationStrategy.GLOBAL_ASSEMBLY)
    return mesh, sj, sp, _build(lp, mesh, lp.OperatorEvaluationStrategy.MATRIX_FREE)


@pytest.mark.parametrize("order,qp_chunk", [(1, None), (2, None), (3, None), (3, 20)])
def test_local_system_matches_reference(order, qp_chunk):
    """K and F of every element, whole or in QP chunks (the last one ragged)."""
    from l3ster_tpu.algsys import local as lj

    from l3ster_tpu_torch.algsys import local as lpl

    blk = _distorted_cube(order).domains[0][0]
    qo = lt.AssemblyOptions().quadrature_order(order)
    kj = lt.wrap_domain_equation_kernel(_diffusion_src, lt.KernelParams(3, 7, 4))
    kp = lp.wrap_domain_equation_kernel(_diffusion_src, lp.KernelParams(3, 7, 4))
    tj = lj.domain_tables(blk.element_type, order, qo)
    Kj, Fj = jax_run(
        lambda v: lj.local_system(kj, tj, lj.element_geometry(tj, v), qp_chunk=qp_chunk), blk.vertices
    )
    tp = lpl.domain_tables(lp.ElementType.HEX, order, qo)
    Kp, Fp = lpl.local_system(kp, tp, lpl.element_geometry(tp, torch.as_tensor(blk.vertices)), qp_chunk=qp_chunk)
    assert Kp.shape == Kj.shape and Fp.shape == Fj.shape
    assert _rel(Kp, Kj) < TOL and _rel(Fp, Fj) < TOL
    assert torch.equal(Kp, Kp.transpose(1, 2)) or _rel(Kp, Kp.transpose(1, 2)) < 1e-14


def test_sparsity_matches_reference(asm_pair):
    """The CSR structure is the reference's, entry for entry."""
    _, sj, sp, _ = asm_pair
    assert sp.nnz == sj.nnz
    np.testing.assert_array_equal(sp._keys, sj._keys)
    np.testing.assert_array_equal(sp._diag_pos, sj._diag_pos)
    _, ij, pj, nj = sj.eliminated_csr()
    _, ip, pp, n = sp.eliminated_csr()
    assert n == nj
    np.testing.assert_array_equal(ip, np.asarray(ij))
    np.testing.assert_array_equal(pp, np.asarray(pj))


def test_values_diagonal_eliminated_match_reference(asm_pair):
    """data, rhs, diagonal(), eliminated_csr() data and the effective rhs."""
    _, sj, sp, _ = asm_pair
    assert _rel(sp.data, sj.data) < TOL
    assert _rel(sp.rhs, sj.rhs) < TOL
    assert _rel(sp.diagonal(), sj.diagonal()) < TOL
    assert _rel(sp.eliminated_csr()[0], sj.eliminated_csr()[0]) < TOL
    assert _rel(sp.effective_rhs(), sj.effective_rhs()) < TOL


def test_assembled_apply_matches_matrix_free(asm_pair):
    """The CSR apply against the port's matrix-free apply of the same problem
    (``tests/test_local_assembly.py::test_matrix_free_apply_matches_assembled``
    at the system level), and the diagonals of the two."""
    _, _, sp, sm = asm_pair
    x = torch.as_tensor(np.random.default_rng(5).normal(size=(sp.n_dofs, 2)))
    assert _rel(sp.operator()(x), sm.operator()(x)) < 1e-12
    assert _rel(sp.diagonal(), sm.diagonal()) < 1e-12
    assert _rel(sp.rhs, sm.rhs) < 1e-12


def test_cg_jacobi_on_assembled_matches_reference(asm_pair):
    """The same iteration count as the reference and x within 1e-10."""
    _, sj, sp, _ = asm_pair
    opts = dict(tol=1e-12, max_iters=2000)
    with xla_optimizations(True):
        rj = sj.solve(lt.CG(lt.IterSolverOpts(**opts), precond=lt.Jacobi()))
    rp = sp.solve(lp.CG(lp.IterSolverOpts(**opts), precond=lp.Jacobi()))
    assert rp.converged and rp.num_iters == rj.num_iters, (rp.num_iters, rj.num_iters)
    assert np.abs(sp.x.numpy() - np.asarray(sj.x)).max() < 1e-10


def test_factory_default_is_assembled():
    """Default parameters build an AssembledSystem on the device asked for;
    the matrix-free strategy still builds a MatrixFreeSystem; condensation
    builds an AssembledSystem and is refused matrix-free (the reference's
    factory rule)."""
    mesh = lp.generate_mesh(lp.make_cube_mesh(np.linspace(0.0, 1.0, 2)), order=1)
    problem = lp.ProblemDefinition(4, [0])
    s = lp.make_algebraic_system(mesh, problem, device="cpu")
    assert isinstance(s, lp.AssembledSystem) and s.device.type == "cpu"
    assert "nnz=" in s.describe()
    mf = lp.AlgebraicSystemParams(eval_strategy=lp.OperatorEvaluationStrategy.MATRIX_FREE)
    assert isinstance(lp.make_algebraic_system(mesh, problem, None, mf, device="cpu"), lp.MatrixFreeSystem)
    cond = lp.AlgebraicSystemParams(cond_policy=lp.CondensationPolicy.ELEMENT_BOUNDARY)
    assert isinstance(lp.make_algebraic_system(mesh, problem, None, cond, device="cpu"), lp.AssembledSystem)
    mf_cond = lp.AlgebraicSystemParams(
        eval_strategy=lp.OperatorEvaluationStrategy.MATRIX_FREE, cond_policy=lp.CondensationPolicy.ELEMENT_BOUNDARY
    )
    with pytest.raises(ValueError, match="static condensation"):
        lp.make_algebraic_system(mesh, problem, None, mf_cond, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            lp.make_algebraic_system(mesh, problem)


def _same_mesh(mp, mj):
    assert mp.dim == mj.dim and mp.n_nodes == mj.n_nodes
    np.testing.assert_array_equal(mp.node_coords, mj.node_coords)
    assert tuple(mp.boundary_ids) == tuple(mj.boundary_ids)
    assert sorted(mp.domains) == sorted(mj.domains)
    for did in mj.domains:
        for bp, bj in zip(mp.domains[did], mj.domains[did], strict=True):
            assert bp.element_type.name == bj.element_type.name and bp.order == bj.order
            np.testing.assert_array_equal(bp.nodes, bj.nodes)
            np.testing.assert_array_equal(bp.vertices, bj.vertices)


def test_line_and_square_generators_match_reference():
    """make_line_mesh and make_square_mesh (ids included) exactly as the
    reference builds them, and the square promoted to order 3."""
    d = np.array([0.0, 0.2, 0.7, 1.0])
    _same_mesh(lp.make_line_mesh(d), lt.make_line_mesh(d))
    ids = dict(domain=7, bottom=11, top=12, left=13, right=14)
    _same_mesh(
        lp.make_square_mesh(d, d[:3], lp.SquareMeshIds(**ids)),
        lt.make_square_mesh(d, d[:3], lt.SquareMeshIds(**ids)),
    )
    _same_mesh(
        lp.generate_mesh(lp.make_square_mesh(d), order=3), lt.generate_mesh(lt.make_square_mesh(d), order=3)
    )


@pytest.mark.parametrize("strategy", ["GLOBAL_ASSEMBLY", "MATRIX_FREE"])
def test_modes_split_operator_and_rhs(asm_pair, strategy):
    """``define_operator`` + ``init_problem`` give the system that
    ``assemble_problem`` (mode "both") gives: the same rhs, diagonal and
    apply; an "operator" contribution adds no rhs and an "rhs" one no
    operator."""
    mesh, _, sp, sm = asm_pair
    both = sp if strategy == "GLOBAL_ASSEMBLY" else sm
    problem = lp.ProblemDefinition(4, [0])
    bcs = lp.BCDefinition(problem)
    bcs.define_dirichlet([5, 6], [0])
    params = lp.AlgebraicSystemParams(eval_strategy=getattr(lp.OperatorEvaluationStrategy, strategy))
    s = lp.make_algebraic_system(_port_mesh(mesh), problem, bcs, params, dtype=torch.float64, device="cpu")
    kd = lp.wrap_domain_equation_kernel(_diffusion_src, lp.KernelParams(3, 7, 4))
    kn = lp.wrap_boundary_equation_kernel(_adiabatic_3d, lp.KernelParams(3, 1, 4))
    s.set_dirichlet_bc_values([0.0], [5], [0])
    s.set_dirichlet_bc_values([1.0], [6], [0])
    s.begin_assembly()
    s.define_operator(kd, [0])
    s.define_operator(kn, [1, 2, 3, 4])
    s.end_assembly()
    assert float(s.rhs.abs().max()) == 0.0
    x = torch.as_tensor(np.random.default_rng(8).normal(size=(s.n_dofs, 1)))
    assert _rel(s.operator()(x), both.operator()(x)) < 1e-14
    epoch = s._assembly_epoch
    s.begin_assembly()
    s.init_problem(kd, [0])
    s.define_operator(kd, [0])
    s.assemble_problem(kn, [1, 2, 3, 4], mode="operator")
    s.end_assembly()
    assert s._assembly_epoch == epoch + 1
    assert _rel(s.rhs, both.rhs) < 1e-14 and _rel(s.diagonal(), both.diagonal()) < 1e-14
    assert _rel(s.operator()(x), both.operator()(x)) < 1e-14
    with pytest.raises(ValueError, match="mode"):
        s.begin_assembly()
        s.assemble_problem(kd, [0], mode="matrix")
