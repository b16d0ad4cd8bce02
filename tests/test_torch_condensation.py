"""The port's static condensation against the JAX package, in f64 on the CPU.

The element traits that pick the condensed nodes, then ELEMENT_BOUNDARY
condensation in the cases of ``tests/test_condensation.py``: 2D diffusion
(p = 3 on 3^2 quads, Dirichlet on two sides, adiabatic on two) and the 3D
bench kernel with a source (p = 3 on a 2^3-hex cube).  After the Schur step
the dof count, ``data``, ``rhs`` and the eliminated CSR equal the
reference's at 1e-11; Klu2 gives the same boundary solution, interior
recovery and nodal fields (1e-10), and the uncondensed system's nodal
solution; the split ``init_problem`` + ``define_operator`` assembly equals
``mode="both"``; two assembly epochs of a field-dependent kernel equal a
fresh system; a partly assembled interior and a matrix-free system raise.
"""

import numpy as np
import pytest
import torch

import l3ster_tpu as lt
import l3ster_tpu_torch as lp
from bench import _adiabatic_3d
from tests.test_diffusion_2d import adiabatic_bc, diffusion_kernel_2d
from tests.test_torch_system import _diffusion_src, _port_mesh, _rel
from tests.torch_reference_fixtures import fast_reference_compiles, per_test_limit  # noqa: F401 (fixtures)

TOL = 1e-11  # data, rhs, eliminated CSR after the Schur step, relative to max |reference|
X_TOL = 1e-10  # solutions and recovered interiors, relative to max |reference|
EB = "ELEMENT_BOUNDARY"


@pytest.mark.parametrize("order", range(1, 7))
@pytest.mark.parametrize("et", ["LINE", "QUAD", "HEX"])
def test_traits_match_reference(et, order):
    """internal_node_indices, boundary_node_indices and side_facet_type."""
    from l3ster_tpu.mesh import traits as tj

    from l3ster_tpu_torch.mesh import traits as tp

    ej, ep = tj.ElementType[et], tp.ElementType[et]
    np.testing.assert_array_equal(tp.internal_node_indices(ep, order), tj.internal_node_indices(ej, order))
    np.testing.assert_array_equal(tp.boundary_node_indices(ep, order), tj.boundary_node_indices(ej, order))
    fj, fp = tj.side_facet_type(ej), tp.side_facet_type(ep)
    assert (fp is None and fj is None) or fp.name == fj.name


def _source_2d(inp, out):
    """Diffusion with a spatially varying source (``tests/test_condensation.py``)."""
    diffusion_kernel_2d(inp, out)
    _, rhs = out
    rhs[0] = 1.0 + inp.point.x
    rhs[1] = inp.point.y


def _make(pkg, mesh, policy, dim):
    """(system, kernels, Dirichlet setter) of the 2D or 3D problem."""
    n_unk = 3 if dim == 2 else 4
    problem = pkg.ProblemDefinition(n_unk, [0])
    bcs = pkg.BCDefinition(problem)
    bcs.define_dirichlet([3, 4] if dim == 2 else [5, 6], [0])
    params = pkg.AlgebraicSystemParams(cond_policy=getattr(pkg.CondensationPolicy, policy))
    if pkg is lt:
        system = lt.make_algebraic_system(mesh, problem, bcs, params)
    else:
        system = lp.make_algebraic_system(_port_mesh(mesh), problem, bcs, params, dtype=torch.float64, device="cpu")
    if dim == 2:
        kd = pkg.wrap_domain_equation_kernel(_source_2d, pkg.KernelParams(dimension=2, n_equations=4, n_unknowns=3))
        kn = pkg.wrap_boundary_equation_kernel(adiabatic_bc, pkg.KernelParams(dimension=2, n_equations=1, n_unknowns=3))
        kdir = pkg.wrap_boundary_residual_kernel(
            lambda i, o: o.__setitem__(0, i.point.x), pkg.KernelParams(dimension=2, n_equations=1)
        )
        system.set_dirichlet_bc_values(kdir, [3, 4], [0])
        return system, kd, kn, [1, 2], pkg.AssemblyOptions(value_order=1, derivative_order=0)
    kd = pkg.wrap_domain_equation_kernel(_diffusion_src, pkg.KernelParams(3, 7, 4))
    kn = pkg.wrap_boundary_equation_kernel(_adiabatic_3d, pkg.KernelParams(3, 1, 4))
    system.set_dirichlet_bc_values([0.0], [5], [0])
    system.set_dirichlet_bc_values([1.0], [6], [0])
    return system, kd, kn, [1, 2, 3, 4], pkg.AssemblyOptions()


def _assemble(pkg, mesh, policy, dim, split=False):
    system, kd, kn, sides, opts = _make(pkg, mesh, policy, dim)
    system.begin_assembly()
    if split:
        system.define_operator(kd, [0], options=opts)
        system.init_problem(kd, [0], options=opts)
    else:
        system.assemble_problem(kd, [0], options=opts)
    system.assemble_problem(kn, sides)
    system.end_assembly()
    return system


def _mesh(dim):
    if dim == 2:
        return lt.generate_mesh(lt.make_square_mesh(np.linspace(0.0, 1.0, 4)), order=3)
    return lt.generate_mesh(lt.make_cube_mesh(np.linspace(0.0, 1.0, 3)), order=3)


@pytest.fixture(scope="module", params=[2, 3], ids=["square", "cube"])
def cond_pair(request):
    """The condensed system in both packages, solved with Klu2, and the
    port's uncondensed one."""
    dim = request.param
    mesh = _mesh(dim)
    sj, sp = _assemble(lt, mesh, EB, dim), _assemble(lp, mesh, EB, dim)
    sj.solve(lt.Klu2())
    sp.solve(lp.Klu2())
    s0 = _assemble(lp, mesh, "NONE", dim)
    s0.solve(lp.Klu2())
    return dim, mesh, sj, sp, s0


def test_schur_step_matches_reference(cond_pair):
    """n_dofs, the CSR structure, data, rhs, the effective rhs and the
    eliminated CSR after the Schur step."""
    dim, mesh, sj, sp, s0 = cond_pair
    n_elements, n_unk = mesh.domains[0][0].n_elements, dim + 1
    assert sp.n_dofs == sj.n_dofs == s0.n_dofs - n_elements * 2**dim * n_unk  # (p - 1)^dim interior nodes
    assert sp.nnz == sj.nnz < s0.nnz
    np.testing.assert_array_equal(sp._keys, sj._keys)
    assert _rel(sp.data, sj.data) < TOL and _rel(sp.rhs, sj.rhs) < TOL
    assert _rel(sp.effective_rhs(), sj.effective_rhs()) < TOL
    assert _rel(sp.eliminated_csr()[0], sj.eliminated_csr()[0]) < TOL
    assert len(sp._cond_aggs) == len(sj._cond_aggs) == 1


def test_recovery_and_update_solution_match_reference(cond_pair):
    """The boundary solution, each block's recovered interiors, the nodal
    fields of ``update_solution``, and the uncondensed solution at every node."""
    dim, mesh, sj, sp, s0 = cond_pair
    assert _rel(sp.x, sj.x) < X_TOL
    (aj, nj, vj), = sj.recover_condensed_solution()
    (ap, np_, vp), = sp.recover_condensed_solution()
    np.testing.assert_array_equal(np_, nj)
    assert _rel(vp, vj) < X_TOL
    n_unk = 3 if dim == 2 else 4
    mj, mp = lt.SolutionManager(mesh, n_unk), lp.SolutionManager(sp.mesh, n_unk, device="cpu")
    m0 = lp.SolutionManager(sp.mesh, n_unk, device="cpu")
    sj.update_solution(range(n_unk), mj, range(n_unk))
    sp.update_solution(range(n_unk), mp, range(n_unk))
    s0.update_solution(range(n_unk), m0, range(n_unk))
    assert _rel(mp.values, mj.values) < X_TOL
    assert _rel(mp.values, m0.values) < X_TOL


def test_split_modes_match_both(cond_pair):
    """define_operator + init_problem through the condensed path equal
    mode="both" (``tests/test_condensation.py::test_condensation_rhs_mode_assembly``)."""
    dim, mesh, _, sp, _ = cond_pair
    s1 = _assemble(lp, mesh, EB, dim, split=True)
    assert _rel(s1.data, sp.data) < 1e-12 and _rel(s1.rhs, sp.rhs) < 1e-12


def _fdep(inp, out):
    """A field-dependent kernel (``tests/test_condensation.py::test_assembled_cross_epoch_caching``)."""
    ops, rhs = out
    A0, Ax, Ay = ops
    k = 1.0 + inp.field_vals[0]
    Ax[0, 0] = k
    Ay[0, 0] = k
    A0[1, 0] = 1.0
    rhs[1] = inp.field_vals[0]


def test_reassembly_across_epochs_matches_reference():
    """Two epochs with different field values equal a fresh system at the
    second epoch's values, and the reference's condensed system."""
    mesh = lt.generate_mesh(lt.make_square_mesh(np.linspace(0.0, 1.0, 3)), order=2)
    coords = np.asarray(mesh.node_coords)
    out = {}
    for pkg in (lt, lp):
        problem = pkg.ProblemDefinition(1, [0])
        bcs = pkg.BCDefinition(problem)
        bcs.define_dirichlet([3, 4])
        params = pkg.AlgebraicSystemParams(cond_policy=pkg.CondensationPolicy.ELEMENT_BOUNDARY)
        kern = pkg.wrap_domain_equation_kernel(_fdep, pkg.KernelParams(dimension=2, n_equations=2, n_unknowns=1, n_fields=1))
        opts = pkg.AssemblyOptions(value_order=1, derivative_order=0)
        if pkg is lt:
            m = mesh
            new = lambda: lt.make_algebraic_system(m, problem, bcs, params)  # noqa: E731
            man = lt.SolutionManager(m, 1)
            set_field = lambda v: setattr(man, "values", man.values.at[:, 0].set(v))  # noqa: E731
        else:
            m = _port_mesh(mesh)
            new = lambda: lp.make_algebraic_system(m, problem, bcs, params, dtype=torch.float64, device="cpu")  # noqa: E731
            man = lp.SolutionManager(m, 1, device="cpu")
            set_field = lambda v: man.values.__setitem__((slice(None), 0), torch.as_tensor(v))  # noqa: E731

        def assemble(system):
            system.begin_assembly()
            system.assemble_problem(kern, [0], man.field_access([0]), options=opts)
            system.end_assembly()

        sa = new()
        set_field(coords[:, 0] * coords[:, 1])
        assemble(sa)
        set_field(coords[:, 0] - 2.0 * coords[:, 1])
        assemble(sa)
        sb = new()
        assemble(sb)
        out[pkg] = (sa, sb)
    (aj, _), (ap, bp) = out[lt], out[lp]
    assert _rel(ap.data, bp.data) < 1e-12 and _rel(ap.rhs, bp.rhs) < 1e-12
    assert _rel(ap.data, aj.data) < TOL and _rel(ap.rhs, aj.rhs) < TOL


def test_partial_interior_and_matrix_free_raise():
    """A kernel covering only some of a condensed domain's active dofs leaves
    the interior blocks singular: end_assembly raises (as the reference
    does) and can be retried after a full assembly; matrix-free with
    condensation raises ValueError."""
    mesh = lp.generate_mesh(lp.make_square_mesh(np.linspace(0.0, 1.0, 3)), order=2)
    problem = lp.ProblemDefinition(3, [0])
    cond = lp.AlgebraicSystemParams(cond_policy=lp.CondensationPolicy.ELEMENT_BOUNDARY)
    s = lp.make_algebraic_system(mesh, problem, None, cond, dtype=torch.float64, device="cpu")
    kd = lp.wrap_domain_equation_kernel(diffusion_kernel_2d, lp.KernelParams(dimension=2, n_equations=4, n_unknowns=3))
    def dx_only(inp, out):
        ops, _ = out
        ops[1][0, 0] = 1.0

    one = lp.wrap_domain_equation_kernel(dx_only, lp.KernelParams(dimension=2, n_equations=1, n_unknowns=1))
    s.begin_assembly()
    s.assemble_problem(one, [0], dof_inds=[0])
    with pytest.raises(RuntimeError, match="partially assembled"):
        s.end_assembly()
    s.assemble_problem(kd, [0])
    s.end_assembly()  # the failed attempt added nothing to data or rhs: the retry succeeds
    fresh = lp.make_algebraic_system(mesh, problem, None, cond, dtype=torch.float64, device="cpu")
    fresh.begin_assembly()
    fresh.assemble_problem(one, [0], dof_inds=[0])
    fresh.assemble_problem(kd, [0])
    fresh.end_assembly()
    assert _rel(s.data, fresh.data) < 1e-14 and _rel(s.rhs + 1.0, fresh.rhs + 1.0) < 1e-14
    mf = lp.AlgebraicSystemParams(
        eval_strategy=lp.OperatorEvaluationStrategy.MATRIX_FREE, cond_policy=lp.CondensationPolicy.ELEMENT_BOUNDARY
    )
    with pytest.raises(ValueError, match="static condensation"):
        lp.make_algebraic_system(mesh, problem, None, mf, device="cpu")
