"""The port's LowOrderMG against the JAX package, in f64 on the CPU.

The reference's cases (``tests/test_lowordermg.py``): 3D diffusion on a
2^3-hex cube at p = 3 and 2D diffusion on 4^2 quads at p = 4.  The
reference's fine systems take ``LATTICE_SF`` forced, the algorithm the
port's AUTO picks (the reference's AUTO picks it only on a TPU); the 2D case
also runs with ``DENSE_MXU`` in both packages.  The numpy helpers, the Chebyshev smoother, an order-1 level, the
coarse dense inverse, one V-cycle (pre-smoothing degree 2 and 0, dof and
lattice layouts) from the same power-iteration start vector in both
packages, and CG + LowOrderMG.  The port's order-1 levels take the lattice
kinds; the reference's take the direct apply on the CPU: the same operators.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import l3ster_tpu as lt
import l3ster_tpu_torch as lp
from bench import _adiabatic_3d, _diffusion_3d
from l3ster_tpu.solve import lowordermg as mgj
from l3ster_tpu_torch.solve import lowordermg as mgp
from tests.test_torch_system import _port_mesh, _rel, jax_run
from tests.torch_reference_fixtures import fast_reference_compiles, per_test_limit  # noqa: F401 (fixtures)


def _diffusion2(inp, out):
    ops, _ = out
    A0, Ax, Ay = ops
    Ax[0, 1] = -1.0
    Ay[0, 2] = -1.0
    A0[1, 1] = -1.0
    Ax[1, 0] = 1.0
    A0[2, 2] = -1.0
    Ay[2, 0] = 1.0
    Ax[3, 2] = 1.0
    Ay[3, 1] = -1.0


def _adiabatic2(inp, out):
    ops, _ = out
    ops[0][0, 1] = inp.normal[0]
    ops[0][0, 2] = inp.normal[1]


def _t_equals_x(inp, out):
    out[0] = inp.point.x


def _build(pkg, mesh, dim, strategy="AUTO"):
    """The reference's 3D (p = 3, 2^3 hexes, Dirichlet T = x on the x faces)
    or 2D (p = 4, 4^2 quads) LowOrderMG problem, matrix-free.  ``strategy``
    "AUTO" runs the port's AUTO against the reference's LATTICE_SF; another
    name runs that strategy in both."""
    n_unk = dim + 1
    problem = pkg.ProblemDefinition(n_unk, [0])
    bcs = pkg.BCDefinition(problem)
    bcs.define_dirichlet([5, 6] if dim == 3 else [3, 4], [0])
    params = pkg.AlgebraicSystemParams(eval_strategy=pkg.OperatorEvaluationStrategy.MATRIX_FREE)
    if dim == 3:
        kd = pkg.wrap_domain_equation_kernel(_diffusion_3d, pkg.KernelParams(3, 7, 4))
        kn = pkg.wrap_boundary_equation_kernel(_adiabatic_3d, pkg.KernelParams(3, 1, 4))
    else:
        kd = pkg.wrap_domain_equation_kernel(_diffusion2, pkg.KernelParams(2, 4, 3))
        kn = pkg.wrap_boundary_equation_kernel(_adiabatic2, pkg.KernelParams(2, 1, 3))
    kdir = pkg.wrap_boundary_residual_kernel(_t_equals_x, pkg.KernelParams(dim, 1))
    if pkg is lt:
        system = lt.make_algebraic_system(mesh, problem, bcs, params)
        strat = getattr(lt.LocalEvalStrategy, "LATTICE_SF" if strategy == "AUTO" else strategy)
    else:
        system = lp.make_algebraic_system(
            _port_mesh(mesh), problem, bcs, params, dtype=torch.float64, device="cpu"
        )
        strat = getattr(lp.LocalEvalStrategy, strategy)
    opts = pkg.AssemblyOptions(value_order=1, derivative_order=0, eval_strategy=strat)
    system.set_dirichlet_bc_values(kdir, [5, 6] if dim == 3 else [3, 4], [0])
    system.begin_assembly()
    system.assemble_problem(kd, [0], options=opts)
    system.assemble_problem(kn, [1, 2, 3, 4] if dim == 3 else [1, 2])
    system.end_assembly()
    return system


@pytest.fixture(scope="module", autouse=True)
def reference_levels_once():
    """The reference builds each order-1 level and coarse inverse once per
    module: its eager level assembly dominates these tests, and every test
    here asks for the same levels of the same two systems."""
    mp = pytest.MonkeyPatch()
    for name in ("_build_p1_system", "_assembled_dense_inv"):
        fn, memo = getattr(mgj, name), {}

        def once(system, axes, dtype, _fn=fn, _memo=memo):
            key = (id(system), tuple(np.asarray(a).tobytes() for a in axes))
            if key not in _memo:
                _memo[key] = (system, _fn(system, axes, dtype))
            return _memo[key][1]

        mp.setattr(mgj, name, once)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def pair3():
    mesh = lt.generate_mesh(lt.make_cube_mesh(np.linspace(0.0, 1.0, 3)), order=3)
    return mesh, _build(lt, mesh, 3), _build(lp, mesh, 3)


@pytest.fixture(scope="module", params=["AUTO", "DENSE_MXU"])
def pair2(request):
    mesh = lt.generate_mesh(lt.make_square_mesh(np.linspace(0.0, 1.0, 5)), order=4)
    return request.param, _build(lt, mesh, 2, request.param), _build(lp, mesh, 2, request.param)


@pytest.fixture
def same_start(monkeypatch):
    """The reference's power iteration starts from the port's start vector."""

    def normal(key, shape, dtype=None):
        level = int(np.asarray(key)[-1])
        return jnp.asarray(mgp._power_start(level, shape[0], torch.float64, "cpu").numpy(), dtype)

    monkeypatch.setattr(jax.random, "normal", normal)


def test_numpy_helpers_match_reference(pair3):
    """_axis_coords, the layout permutations, _coarsen and _interp_1d, exactly."""
    mesh, _, sp = pair3
    axj, axp = mgj._axis_coords(mesh), mgp._axis_coords(sp.mesh)
    for a, b in zip(axp, axj, strict=True):
        np.testing.assert_array_equal(a, b)
    v = np.random.default_rng(0).normal(size=(24, 2))
    for f in ("_perm_to_lat", "_perm_from_lat"):
        np.testing.assert_array_equal(getattr(mgp, f)(v, 6, 4), getattr(mgj, f)(v, 6, 4))
        np.testing.assert_array_equal(getattr(mgp, f)(torch.as_tensor(v), 6, 4).numpy(), getattr(mgj, f)(v, 6, 4))
        np.testing.assert_array_equal(getattr(mgp, f)(v[:, 0], 6, 4), getattr(mgj, f)(v[:, 0], 6, 4))
    for n in (2, 3, 7, 8):
        idx = np.sort(np.random.default_rng(n).uniform(size=n))
        np.testing.assert_array_equal(mgp._coarsen(idx), mgj._coarsen(idx))
        np.testing.assert_array_equal(mgp._interp_1d(idx, mgp._coarsen(idx)), mgj._interp_1d(idx, mgj._coarsen(idx)))
    assert mgp._axis_coords(lp.make_cylinder_in_channel_2d()) is None


@pytest.mark.parametrize("z0_zero,degree", [(True, 3), (False, 2), (False, 0)])
def test_cheb_matches_reference(z0_zero, degree):
    """Chebyshev smoothing of one SPD operator at a given lambda_max."""
    rng = np.random.default_rng(1)
    B = rng.normal(size=(12, 12))
    A = B @ B.T + 12 * np.eye(12)
    r, z0 = rng.normal(size=(12, 2)), rng.normal(size=(12, 2))
    dinv = 1.0 / np.diag(A)
    lam = float(np.linalg.eigvalsh(A * dinv[:, None]).max())
    zj = mgj._cheb(lambda x, M: M @ x, r, z0, dinv, lam, (A,), degree, 8.0, z0_zero)
    At = torch.as_tensor(A)
    zp = mgp._cheb(lambda x, M: M @ x, torch.as_tensor(r), torch.as_tensor(z0), torch.as_tensor(dinv), lam, (At,), degree, 8.0, z0_zero)
    np.testing.assert_allclose(zp.numpy(), np.asarray(zj), rtol=0, atol=1e-13 * np.abs(np.asarray(zj)).max())


def test_order1_level_matches_reference(pair3):
    """The first coarse level (p = 1 on every second lattice node): operator
    and diagonal against the reference's ``_build_p1_system``, to 1e-11; its
    3D operator takes the lattice kinds."""
    mesh, sj, sp = pair3
    ax = [mgj._coarsen(a) for a in mgj._axis_coords(mesh)]
    lj = mgj._build_p1_system(sj, ax, jnp.float64)
    lpl = mgp._build_p1_system(sp, ax)
    assert lpl.device == sp.device and lpl.dtype == sp.dtype
    assert [d[0] for _, d in lpl._operators()[1]] == ["lattice_sf_const_diag"] + ["face_banded"] * 4
    x = np.random.default_rng(2).normal(size=(lj.n_dofs, 1))
    fn, consts = lj.operator_parts()
    assert _rel(lpl.operator()(torch.as_tensor(x)), jax_run(fn, x, *consts)) < 1e-11
    assert _rel(lpl.diagonal(), lj.diagonal()) < 1e-11


def test_coarse_inverse_matches_reference(pair3):
    """The coarse dense inverse of the assembled order-1 system, to 1e-9 (the
    V-cycle's coarse level here: 4^3 nodes are below ``coarse_max_dofs``)."""
    mesh, sj, sp = pair3
    ax = [mgj._coarsen(a) for a in mgj._axis_coords(mesh)]
    Bj = mgj._assembled_dense_inv(sj, ax, jnp.float64)
    Bp = mgp._assembled_dense_inv(sp, ax)
    assert _rel(Bp, Bj) < 1e-9


@pytest.mark.parametrize("pre_degree", [None, 0])
@pytest.mark.parametrize("layout", ["dof", "lattice"])
def test_vcycle_matches_reference(pair3, same_start, pre_degree, layout):
    """One V-cycle application (smoothing degree 2; pre-smoothing degree 2,
    the default, or 0), from the same start vector, to 1e-10.  The setups go
    through the solvers' per-epoch caches, so the CG test below reuses the
    lattice-layout default's."""
    from l3ster_tpu.solve.krylov import _precond_parts as parts_j

    from l3ster_tpu_torch.solve.krylov import _precond_parts as parts_p

    _, sj, sp = pair3
    aj, cj = parts_j(lt.LowOrderMG(pre_degree=pre_degree), sj, layout)
    ap, cp = parts_p(lp.LowOrderMG(pre_degree=pre_degree), sp, layout)
    r = np.random.default_rng(3).normal(size=(sj.n_dofs, 1))
    assert _rel(ap(torch.as_tensor(r), *cp), jax_run(aj, r, *cj)) < 1e-10


def _solve_pair(sj, sp, mg_kw, tol):
    """CG + LowOrderMG from zero in both packages: converged, iterations
    within 2 of the reference's and x within 1e-8 of it; then CG + Jacobi
    on the port's system takes more iterations."""
    sj.set_solution_vector(sj.x * 0)
    sp.set_solution_vector(sp.x * 0)
    rj = sj.solve(lt.CG(lt.IterSolverOpts(tol=tol, max_iters=3000), precond=lt.LowOrderMG(**mg_kw)))
    rp = sp.solve(lp.CG(lp.IterSolverOpts(tol=tol, max_iters=3000), precond=lp.LowOrderMG(**mg_kw)))
    assert rp.converged and abs(rp.num_iters - rj.num_iters) <= 2, (rp.num_iters, rj.num_iters)
    assert np.abs(sp.x.numpy() - np.asarray(sj.x)).max() < 1e-8
    sp.set_solution_vector(sp.x * 0)
    rjac = sp.solve(lp.CG(lp.IterSolverOpts(tol=tol, max_iters=3000), precond=lp.Jacobi()))
    assert rp.num_iters < rjac.num_iters, (rp.num_iters, rjac.num_iters)


def test_cg_lowordermg_3d_matches_reference(pair3, same_start):
    """CG + LowOrderMG (lattice layout): converged, iterations within 2 of the
    reference's and below CG + Jacobi's, x within 1e-8 of the reference's."""
    _, sj, sp = pair3
    assert sp.lattice_layout_key() is not None and sj.lattice_layout_key() is not None
    _solve_pair(sj, sp, dict(), 1e-11)


def test_cg_lowordermg_2d_matches_reference(pair2, same_start):
    """The 2D case (4^2 quads at p = 4, smoothing degree 3, as
    ``tests/test_lowordermg.py:63-86`` runs it), on the fine level by the
    port's AUTO (the 2D lattice chain, solved in the lattice layout; the
    reference forced to LATTICE_SF) and by DENSE_MXU in both packages; the
    faces are direct."""
    strategy, sj, sp = pair2
    fine = "lattice_sf_const" if strategy == "AUTO" else "dense_const"
    assert [d[0] for _, d in sp._operators()[1]] == [fine, "direct", "direct"]
    assert (sp.lattice_layout_key() is not None) == (strategy == "AUTO")
    assert sp.lattice_layout_key() == sj.lattice_layout_key()
    _solve_pair(sj, sp, dict(smooth_degree=3), 1e-12)
