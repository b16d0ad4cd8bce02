"""The port's periodic and normalization conditions against the JAX package,
in f64 on the CPU.

* Periodic pairs and per-component masks, and the dof maps built from them,
  equal the reference's (the cases of ``tests/test_periodic_components.py``).
* The periodic advection test (``tests/test_advection_periodic.py``, its
  size: 4 x 3 quads at p = 4, BDF3, DT 0.05) over one full period of 20
  steps, matrix-free in both packages: the fields agree to 1e-10 after the
  period (both CG solves run to 1e-13) and the error stays under the
  example's 5%; assembled, four steps.  The port's AUTO takes
  ``dense_const`` (its operator kernel reads no fields; periodic aliasing
  leaves no lattice), the reference's CPU AUTO the sum-factorized apply: the
  same operator.
* Normalization: pure-Neumann 2D diffusion with T pinned by
  ``BCDefinition.normalize``; the same pinned dof and solutions within 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import l3ster_tpu as lt
import l3ster_tpu_torch as lp
from l3ster_tpu.bcs.periodic import match_periodic_nodes as match_j
from l3ster_tpu.dofs.dofmap import build_dof_map as build_dof_map_j
from l3ster_tpu_torch.bcs.periodic import match_periodic_nodes as match_p
from l3ster_tpu_torch.dofs.dofmap import build_dof_map as build_dof_map_p
from tests.test_torch_system import _port_mesh
from tests.torch_reference_fixtures import fast_reference_compiles, per_test_limit  # noqa: F401 (fixtures)

DOMAIN, BOTTOM, TOP, LEFT, RIGHT = 0, 1, 2, 3, 4


def _periodic_bcs(pkg, max_dofs, dof_inds, W):
    problem = pkg.ProblemDefinition(max_dofs, [DOMAIN])
    bcs = pkg.BCDefinition(problem)
    bcs.define_periodic([LEFT], [RIGHT], [W, 0.0, 0.0], dof_inds=dof_inds)
    return problem, bcs


@pytest.mark.parametrize("dof_inds", [[0], [1], [0, 1], None])
def test_pairs_masks_and_dofmap_match_reference(dof_inds):
    """Pairs, masks and the dof map of the component cases, and the system's
    dof numbering and Dirichlet dofs."""
    mesh = lt.generate_mesh(lt.make_square_mesh(np.linspace(0.0, 1.0, 4), np.linspace(0.0, 1.0, 3)), order=2)
    pmesh = _port_mesh(mesh)
    pj, bj = _periodic_bcs(lt, 2, dof_inds, 1.0)
    pp, bp = _periodic_bcs(lp, 2, dof_inds, 1.0)
    pairs_j, masks_j = match_j(mesh, bj, max_dofs=2)
    pairs_p, masks_p = match_p(pmesh, bp, max_dofs=2)
    np.testing.assert_array_equal(pairs_p, pairs_j)
    np.testing.assert_array_equal(masks_p, masks_j)
    dm_j = build_dof_map_j(mesh, pj, pairs_j, periodic_dof_masks=masks_j)
    dm_p = build_dof_map_p(pmesh, pp, pairs_p, periodic_dof_masks=masks_p)
    np.testing.assert_array_equal(dm_p.node_dof, dm_j.node_dof)
    assert dm_p.n_dofs == dm_j.n_dofs
    bj.define_dirichlet([BOTTOM], [0])
    bp.define_dirichlet([BOTTOM], [0])
    sj = lt.make_algebraic_system(mesh, pj, bj)
    sp = lp.make_algebraic_system(pmesh, pp, bp, dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(sp.dofmap.node_dof, sj.dofmap.node_dof)
    np.testing.assert_array_equal(sp.dirichlet_dofs, sj.dirichlet_dofs)


# the reference test's advection problem
NX = np.linspace(-0.5, 0.5, 5)
NY = np.linspace(0.0, 0.5, 4)
W, H = NX[-1] - NX[0], NY[-1] - NY[0]
BDF_LEADING, BDF_COEFS = 11.0 / 6.0, (3.0, -1.5, 1.0 / 3.0)
DT, U = 0.05, 1.0


def _analytic(exp):
    def fn(inp, out):
        x_dv = (inp.point.x - inp.point.time * U - NX[0]) % W + NX[0]
        out[0] = exp(-10.0 * x_dv * x_dv)

    return fn


def _init(inp, out):
    ops, rhs = out
    A0, Ax, Ay = ops
    A0[0, 0] = BDF_LEADING
    Ax[0, 0] = U * DT
    rhs[0] = BDF_COEFS[0] * inp.field_vals[0] + BDF_COEFS[1] * inp.field_vals[1] + BDF_COEFS[2] * inp.field_vals[2]


def _eval(inp, out):
    ops, _ = out
    A0, Ax, Ay = ops
    A0[0, 0] = BDF_LEADING
    Ax[0, 0] = U * DT


def _advect(pkg, mesh, n_steps, strategy="MATRIX_FREE"):
    """The reference test's loop, CG + Jacobi to 1e-13; returns (system,
    newest field, normalized L2 error in %)."""
    exp = jnp.exp if pkg is lt else torch.exp
    problem = pkg.ProblemDefinition(1, [DOMAIN])
    bcs = pkg.BCDefinition(problem)
    bcs.define_periodic([LEFT], [RIGHT], [W, 0.0, 0.0])
    bcs.define_dirichlet([TOP, BOTTOM])
    params = pkg.AlgebraicSystemParams(eval_strategy=getattr(pkg.OperatorEvaluationStrategy, strategy))
    kw = {} if pkg is lt else dict(dtype=torch.float64, device="cpu")
    system = pkg.make_algebraic_system(mesh, problem, bcs, params, **kw)
    init_k = pkg.wrap_domain_equation_kernel(_init, pkg.KernelParams(dimension=2, n_equations=1, n_fields=3))
    eval_k = pkg.wrap_domain_equation_kernel(_eval, pkg.KernelParams(dimension=2, n_equations=1))
    sol_k = pkg.wrap_domain_residual_kernel(_analytic(exp), pkg.KernelParams(dimension=2, n_equations=1))
    sol_bc = pkg.wrap_boundary_residual_kernel(_analytic(exp), pkg.KernelParams(dimension=2, n_equations=1))
    hist = [0, 1, 2]
    manager = pkg.SolutionManager(mesh, 3, **kw)
    for i in hist:
        manager.set_fields_from_kernel(sol_k, [DOMAIN], [i], time=-DT * i)
        manager.set_fields_from_kernel(sol_bc, [BOTTOM, TOP, LEFT, RIGHT], [i], time=-DT * i)
    solver = pkg.CG(pkg.IterSolverOpts(tol=1e-13, max_iters=2000), precond=pkg.Jacobi())
    for step in range(1, n_steps + 1):
        system.set_dirichlet_bc_values(sol_bc, [BOTTOM, TOP], [0], time=step * DT)
        system.begin_assembly()
        if strategy == "MATRIX_FREE":
            system.init_problem(init_k, [DOMAIN], manager.field_access(hist))
            system.define_operator(eval_k, [DOMAIN])
        else:
            system.assemble_problem(init_k, [DOMAIN], manager.field_access(hist))
        system.end_assembly()
        assert system.solve(solver).converged
        system.update_solution([0], manager, [hist[-1]])
        hist = [hist[-1]] + hist[:-1]

    def err_kernel(inp, out):
        _analytic(exp)(inp, out)
        out[0] = inp.field_vals[0] - out[0]

    ek = pkg.wrap_domain_residual_kernel(err_kernel, pkg.KernelParams(dimension=2, n_equations=1, n_fields=1))
    e = pkg.compute_norm_l2(ek, mesh, [DOMAIN], manager.field_access([hist[0]]), time=n_steps * DT)
    return system, np.asarray(manager.values[:, hist[0]]), float(e[0, 0]) / (W * H) * 100.0


def test_advection_period_matches_reference():
    mesh = lt.generate_mesh(lt.make_square_mesh(NX, NY), order=4)
    n_steps = round(W / DT)
    sj, fj, ej = _advect(lt, mesh, n_steps)
    sp, fp, ep = _advect(lp, _port_mesh(mesh), n_steps)
    assert [d[0] for _, d in sp._operators()[1]] == ["dense_const"]
    assert sp.n_dofs == sj.n_dofs == mesh.n_nodes - (len(NY) - 1) * 4 - 1
    assert np.abs(fp - fj).max() < 1e-10
    assert abs(ep - ej) < 1e-8 and ep < 5.0


def test_advection_assembled_matches_reference():
    """The assembled system on the periodic dof map (the reference test's
    GLOBAL_ASSEMBLY case), four steps: fields within 1e-10."""
    mesh = lt.generate_mesh(lt.make_square_mesh(NX, NY), order=4)
    sj, fj, _ = _advect(lt, mesh, 4, "GLOBAL_ASSEMBLY")
    sp, fp, _ = _advect(lp, _port_mesh(mesh), 4, "GLOBAL_ASSEMBLY")
    assert type(sp).__name__ == "AssembledSystem" and sp.n_dofs == sj.n_dofs
    assert np.abs(fp - fj).max() < 1e-10


def _neumann2(pkg):
    def kern(inp, out):
        ops, rhs = out
        A0, Ax, Ay = ops
        Ax[0, 1] = -1.0
        Ay[0, 2] = -1.0
        A0[1, 1] = -1.0
        Ax[1, 0] = 1.0
        A0[2, 2] = -1.0
        Ay[2, 0] = 1.0
        Ax[3, 2] = 1.0
        Ay[3, 1] = -1.0
        rhs[0] = (jnp if pkg is lt else torch).cos(np.pi * inp.point.x)  # zero mean: compatible

    return kern


def _adiabatic2(inp, out):
    ops, _ = out
    ops[0][0, 1] = inp.normal[0]
    ops[0][0, 2] = inp.normal[1]


def test_normalization_matches_reference():
    """Pure Neumann diffusion with T normalized: the same pinned dof and CG +
    Jacobi solutions (to 1e-13) within 1e-10; the port runs its 2D lattice
    chain, the reference LATTICE_SF."""
    mesh = lt.generate_mesh(lt.make_square_mesh(np.linspace(0.0, 1.0, 4)), order=3)
    xs = []
    for pkg in (lt, lp):
        problem = pkg.ProblemDefinition(3, [DOMAIN])
        bcs = pkg.BCDefinition(problem)
        bcs.normalize([0])
        params = pkg.AlgebraicSystemParams(eval_strategy=pkg.OperatorEvaluationStrategy.MATRIX_FREE)
        if pkg is lt:
            system = lt.make_algebraic_system(mesh, problem, bcs, params)
            opts = lt.AssemblyOptions(eval_strategy=lt.LocalEvalStrategy.LATTICE_SF)
        else:
            system = lp.make_algebraic_system(_port_mesh(mesh), problem, bcs, params, dtype=torch.float64, device="cpu")
            opts = lp.AssemblyOptions()
        system.begin_assembly()
        kd = pkg.wrap_domain_equation_kernel(_neumann2(pkg), pkg.KernelParams(2, 4, 3))
        system.assemble_problem(kd, [DOMAIN], options=opts)
        system.assemble_problem(pkg.wrap_boundary_equation_kernel(_adiabatic2, pkg.KernelParams(2, 1, 3)), [1, 2, 3, 4])
        system.end_assembly()
        assert system.solve(pkg.CG(pkg.IterSolverOpts(tol=1e-13, max_iters=5000), precond=pkg.Jacobi())).converged
        xs.append((system, np.asarray(system.x)))
    (sj, xj), (sp, xp) = xs
    assert [d[0] for _, d in sp._operators()[1]][0] == "lattice_sf_const"
    np.testing.assert_array_equal(sp.dirichlet_dofs, sj.dirichlet_dofs)
    assert len(sp.dirichlet_dofs) == 1
    assert np.abs(xp - xj).max() < 1e-10
