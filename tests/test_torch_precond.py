"""The port's preconditioners, triangular solves and GMRES against the JAX package (f64, CPU).

The reference's own solver matrix (``tests/test_solvers.py``: a small SPD
and a nonsymmetric dense system) through every solver and preconditioner,
iteration counts within one of the reference's and solutions within 1e-10;
GMRES over restart lengths and its convergence-failure report; and, on the
reference's small assembled LSFEM system (2D diffusion, p = 3 on 4^2 quads),
the level schedules and triangular solves, the host ILU(0) (C++ and numpy
each against the reference's same path), every preconditioner's apply on one
residual at 1e-11, and the reference's bar on CG iterations.  Chebyshev's
power iteration starts, in both packages, from the port's start vector.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import l3ster_tpu as lt
import l3ster_tpu_torch as lp
from l3ster_tpu_torch.solve import hostops
from l3ster_tpu_torch.solve import precond as pp
from l3ster_tpu_torch.solve.tri import build_tri_solve, ilu0_factor, tri_schedule
from tests.test_diffusion_2d import adiabatic_bc, diffusion_kernel_2d
from tests.test_solvers import _nonsym_system, _spd_system
from tests.test_torch_system import _port_mesh, _rel
from tests.torch_reference_fixtures import fast_reference_compiles, per_test_limit, xla_optimizations  # noqa: F401 (fixtures)

APPLY_TOL = 1e-11  # a preconditioner's apply / a triangular solve, relative to max |reference|
X_TOL = 1e-10  # solutions, relative to max |reference|


class _PortDense:
    """The port's counterpart of the reference tests' ``_DenseSystem``."""

    def __init__(self, A: np.ndarray, b: np.ndarray):
        self.A = torch.as_tensor(A)
        self.b = torch.as_tensor(b).reshape(len(b), -1)
        self.n_dofs = A.shape[0]
        self.x = torch.zeros_like(self.b)
        self.dtype, self.device = self.b.dtype, self.b.device

    def operator_parts(self, layout="dof"):
        return (lambda x, A: A @ x), (self.A,)

    def operator(self):
        return lambda x: self.A @ x

    def effective_rhs(self):
        return self.b

    def diagonal(self):
        return torch.diagonal(self.A)

    def solution_vector(self):
        return self.x

    def set_solution_vector(self, x):
        self.x = x.reshape(self.b.shape)

    def eliminated_csr(self):
        n = self.n_dofs
        return self.A.reshape(-1), np.tile(np.arange(n), n), np.arange(n + 1) * n, n

    def eliminated_dense(self):
        return self.A.numpy()


def _pair(make):
    system, x_exact = make()
    return system, _PortDense(np.asarray(system.A), np.asarray(system.b)), x_exact


@pytest.fixture
def same_start(monkeypatch):
    """The reference's Chebyshev starts from the port's start vector."""

    def normal(key, shape, dtype=None):
        return jnp.asarray(pp.chebyshev_start(shape[0], torch.float64, "cpu").numpy(), dtype)

    monkeypatch.setattr(jax.random, "normal", normal)


def _solvers(pkg):
    """``tests/test_solvers.py:SOLVERS`` for either package."""
    o = pkg.IterSolverOpts
    return {
        "cg-identity": pkg.CG(o(tol=1e-12, max_iters=2000)),
        "cg-jacobi": pkg.CG(o(tol=1e-12, max_iters=2000), precond=pkg.Jacobi()),
        "cg-richardson": pkg.CG(o(tol=1e-12, max_iters=4000), precond=pkg.Richardson(0.4)),
        "cg-chebyshev": pkg.CG(o(tol=1e-12, max_iters=2000), precond=pkg.Chebyshev()),
        "gmres-identity": pkg.Gmres(o(tol=1e-10, max_iters=4000)),
        "gmres-jacobi": pkg.Gmres(o(tol=1e-10, max_iters=4000), precond=pkg.Jacobi()),
        "cg-blockjacobi": pkg.CG(o(tol=1e-12, max_iters=2000), precond=pkg.BlockJacobi(block_size=3)),
        "cg-sgs": pkg.CG(o(tol=1e-12, max_iters=2000), precond=pkg.SGS()),
        "cg-ilu0": pkg.CG(o(tol=1e-12, max_iters=2000), precond=pkg.ILU0()),
        "gmres-ilu0": pkg.Gmres(o(tol=1e-10, max_iters=4000), precond=pkg.ILU0()),
        "gmres-ilut": pkg.Gmres(o(tol=1e-10, max_iters=4000), precond=pkg.ILUT(drop_tol=1e-5)),
        "cg-jacobi-3": pkg.CG(o(tol=1e-12, max_iters=4000), precond=pkg.Jacobi(sweeps=3, damping=0.9)),
        "cg-sgs-2": pkg.CG(o(tol=1e-12, max_iters=4000), precond=pkg.SGS(sweeps=2)),
        "klu2": pkg.Klu2(),
        "lapack": pkg.Lapack(),
    }


@pytest.mark.parametrize("name", list(_solvers(lp)))
def test_solver_matrix_matches_reference(name, same_start):
    """Each solver on the reference's SPD system: the reference's iteration
    count within one, x within 1e-10 of the reference's and 1e-7 of the exact
    solution (the reference's own bar)."""
    sj, sp, x_exact = _pair(_spd_system)
    with xla_optimizations(True):
        rj = _solvers(lt)[name].solve(sj)
    rp = _solvers(lp)[name].solve(sp)
    xj, xp = np.asarray(sj.solution_vector()), sp.solution_vector().numpy()
    assert abs(rp.num_iters - rj.num_iters) <= 1, (rp.num_iters, rj.num_iters)
    assert _rel(xp, xj) < X_TOL
    assert np.abs(xp - x_exact).max() / np.abs(x_exact).max() < 1e-7


@pytest.mark.parametrize("restart", [10, 30, 200])
def test_gmres_nonsymmetric_matches_reference(restart):
    """GMRES + Jacobi on the reference's nonsymmetric system, two right-hand
    sides, across restart lengths."""
    sj, sp, x_exact = _pair(_nonsym_system)
    opts = dict(tol=1e-11, max_iters=2000, restart=restart)
    with xla_optimizations(True):
        rj = lt.Gmres(lt.IterSolverOpts(**opts), precond=lt.Jacobi()).solve(sj)
    rp = lp.Gmres(lp.IterSolverOpts(**opts), precond=lp.Jacobi()).solve(sp)
    assert abs(rp.num_iters - rj.num_iters) <= 1 and rp.num_iters > 0, (rp.num_iters, rj.num_iters)
    assert rp.tol < 1e-11 and rp.converged
    assert _rel(sp.x.numpy(), np.asarray(sj.x)) < X_TOL
    assert np.abs(sp.x.numpy() - x_exact).max() / np.abs(x_exact).max() < 1e-8


def test_convergence_failure_reports_match_reference():
    """A capped CG and a capped GMRES report their honest counts and
    residuals, as the reference does, with the port's RuntimeWarning."""
    for make, solver, opts in (
        (_spd_system, "CG", dict(tol=1e-14, max_iters=3)),
        (_nonsym_system, "Gmres", dict(tol=1e-14, max_iters=5, restart=5)),
    ):
        sj, sp, _ = _pair(make)
        rj = getattr(lt, solver)(lt.IterSolverOpts(**opts)).solve(sj)
        with pytest.warns(RuntimeWarning, match="NOT CONVERGED"):
            rp = getattr(lp, solver)(lp.IterSolverOpts(**opts)).solve(sp)
        assert rp.num_iters == rj.num_iters >= opts["max_iters"], (rp.num_iters, rj.num_iters)
        assert abs(rp.tol - float(rj.tol)) <= 1e-10 * float(rj.tol) and rp.tol > 1e-14
        assert rp.capped and not rp.converged


def test_gmres_early_exit():
    """The Arnoldi loop stops at convergence: k distinct eigenvalues take
    about k steps with restart = n (``tests/test_solvers.py::test_gmres_early_exit``)."""
    from l3ster_tpu_torch.solve.krylov import gmres_solve

    rng = np.random.default_rng(3)
    n, k = 64, 5
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    A = Q @ np.diag(np.resize(np.linspace(1.0, 2.0, k), n)) @ Q.T
    b = rng.normal(size=(n, 1))
    At = torch.as_tensor(A)
    x, it, res = gmres_solve(lambda v: At @ v, torch.as_tensor(b), tol=1e-10, max_iters=1000, restart=n)
    assert res < 1e-10 and it <= k + 2, it
    assert np.abs(x.numpy() - np.linalg.solve(A, b)).max() < 1e-8


def test_verbosity_two_prints_each_iteration(capsys):
    """verbosity >= 2: one line per CG iteration and per GMRES cycle, then
    the summary line."""
    _, sp, _ = _pair(_spd_system)
    r = lp.CG(lp.IterSolverOpts(tol=1e-12, max_iters=2000, verbosity=2), precond=lp.Jacobi()).solve(sp)
    out = capsys.readouterr().out.splitlines()
    its = [ln for ln in out if ln.startswith("CG it ")]
    assert len(its) == r.num_iters and its[-1].startswith(f"CG it {r.num_iters}: rel res")
    assert out[-1].startswith(f"CG: {r.num_iters} iterations")
    _, sp, _ = _pair(_nonsym_system)
    r = lp.Gmres(lp.IterSolverOpts(tol=1e-11, max_iters=2000, restart=10, verbosity=2)).solve(sp)
    out = capsys.readouterr().out.splitlines()
    assert out[-2].startswith(f"GMRES it {r.num_iters}: rel res") and out[-1].startswith("GMRES:")


# -- the small assembled LSFEM system (``tests/test_solvers.py:171-206``) --------


def _lsfem(pkg, mesh):
    problem = pkg.ProblemDefinition(3, [0])
    bcs = pkg.BCDefinition(problem)
    bcs.define_dirichlet([3, 4], [0])
    if pkg is lt:
        system = lt.make_algebraic_system(mesh, problem, bcs)
    else:
        system = lp.make_algebraic_system(_port_mesh(mesh), problem, bcs, dtype=torch.float64, device="cpu")
    kd = pkg.wrap_domain_equation_kernel(diffusion_kernel_2d, pkg.KernelParams(dimension=2, n_equations=4, n_unknowns=3))
    kn = pkg.wrap_boundary_equation_kernel(adiabatic_bc, pkg.KernelParams(dimension=2, n_equations=1, n_unknowns=3))
    kdir = pkg.wrap_boundary_residual_kernel(
        lambda i, o: o.__setitem__(0, i.point.x), pkg.KernelParams(dimension=2, n_equations=1)
    )
    system.set_dirichlet_bc_values(kdir, [3, 4], [0])
    system.begin_assembly()
    system.assemble_problem(kd, [0], options=pkg.AssemblyOptions(value_order=1, derivative_order=0))
    system.assemble_problem(kn, [1, 2])
    system.end_assembly()
    return system


@pytest.fixture(scope="module")
def lsfem_pair():
    mesh = lt.generate_mesh(lt.make_square_mesh(np.linspace(0.0, 1.0, 5)), order=3)
    sj, sp = _lsfem(lt, mesh), _lsfem(lp, mesh)
    data, indices, indptr, n = sp.eliminated_csr()
    return sj, sp, (data.numpy(), indices, indptr, n)


@pytest.mark.parametrize("lower,unit_diag", [(True, True), (True, False), (False, True), (False, False)])
def test_tri_solve_matches_reference(lsfem_pair, lower, unit_diag):
    """The level schedule equals the reference's ``_tri_consts_np`` maps
    without their padding, and the solve equals the reference's to 1e-11."""
    from l3ster_tpu.solve import tri as tj

    sj, _, (data, indices, indptr, n) = lsfem_pair
    ROWS, DINV, COLS, VALS, SEG, _, n_lv = tj._tri_consts_np(data, indices, indptr, n, lower, unit_diag)
    rows, dinv, row_off, cols, vals, seg, ent_off = tri_schedule(data, indices, indptr, n, lower, unit_diag)
    assert len(row_off) - 1 == n_lv > 1
    for lv in range(n_lv):
        r = slice(row_off[lv], row_off[lv + 1])
        e = slice(ent_off[lv], ent_off[lv + 1])
        k = r.stop - r.start
        np.testing.assert_array_equal(ROWS[lv, :k], rows[r])
        assert (ROWS[lv, k:] == n).all()
        np.testing.assert_array_equal(DINV[lv, :k], dinv[r])
        m = e.stop - e.start
        np.testing.assert_array_equal(COLS[lv, :m], cols[e])
        np.testing.assert_array_equal(VALS[lv, :m], vals[e])
        np.testing.assert_array_equal(SEG[lv, :m], seg[e])
        assert (COLS[lv, m:] == n).all()
    b = np.random.default_rng(11).normal(size=(n, 2))
    fj, cj = tj.build_tri_solve(data, indices, indptr, n, lower, unit_diag, jnp.float64)
    fp, cp = build_tri_solve(data, indices, indptr, n, lower, unit_diag, torch.float64, "cpu")
    xj = jax.jit(fj)(jnp.asarray(b), *cj)
    assert _rel(fp(torch.as_tensor(b), *cp), xj) < APPLY_TOL
    assert fp.n_levels == n_lv and fp.launches == 3 + 3 * (n_lv - 1)


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_ilu0_factor_matches_reference(lsfem_pair, monkeypatch, path):
    """The host ILU(0): the port's C++ helper against the reference's native
    library, and the numpy loops against each other; the levels too."""
    import l3ster_tpu.native as nj
    from l3ster_tpu.solve import tri as tj

    _, _, (data, indices, indptr, n) = lsfem_pair
    if path == "numpy":
        monkeypatch.setattr(nj, "_lib", False)
        monkeypatch.setitem(hostops._state, "lib", None)
    else:
        assert hostops.available() and nj.available()
    fj = tj.ilu0_factor(data, indices, indptr, n)
    fp = ilu0_factor(data, indices, indptr, n)
    assert hostops.backend["ilu0_factor"] == path
    assert _rel(fp, fj) < 1e-14
    for lower in (True, False):
        np.testing.assert_array_equal(hostops.tri_levels(indices, indptr, n, lower), tj._levels(n, indptr, indices, lower))
    assert hostops.backend["tri_levels"] == path
    with pytest.raises(ZeroDivisionError):
        ilu0_factor(np.zeros_like(data), indices, indptr, n)


PRECONDS = [
    ("richardson", lambda pkg: pkg.Richardson(0.4)),
    ("jacobi", lambda pkg: pkg.Jacobi()),
    ("jacobi-3", lambda pkg: pkg.Jacobi(sweeps=3, damping=0.9)),
    ("chebyshev", lambda pkg: pkg.Chebyshev()),
    ("blockjacobi", lambda pkg: pkg.BlockJacobi()),
    ("sgs", lambda pkg: pkg.SGS()),
    ("sgs-2", lambda pkg: pkg.SGS(sweeps=2)),
    ("ilu0", lambda pkg: pkg.ILU0()),
    ("ilut", lambda pkg: pkg.ILUT(drop_tol=1e-5)),
]


@pytest.mark.parametrize("name,make", PRECONDS, ids=[p[0] for p in PRECONDS])
def test_precond_apply_matches_reference(lsfem_pair, same_start, name, make):
    """M^-1 r of each preconditioner on one residual (two columns), to 1e-11."""
    sj, sp, _ = lsfem_pair
    r = np.random.default_rng(12).normal(size=(sp.n_dofs, 2))
    fj, cj = make(lt).setup_parts(sj)
    fp, cp = make(lp).setup_parts(sp)
    yj = jax.jit(fj)(jnp.asarray(r), *cj)
    assert _rel(fp(torch.as_tensor(r), *cp), yj) < APPLY_TOL


@pytest.mark.parametrize("start", ["zero", "previous"])
def test_strong_preconditioners_cut_iterations(lsfem_pair, start):
    """CG on the LSFEM system with Jacobi, BlockJacobi, SGS and ILU0, each
    count within one of the reference's.  From the previous solve's x, as
    ``tests/test_solvers.py::test_strong_preconditioners_cut_iterations``
    runs them, ILU0 and SGS take at most a third of Jacobi's iterations and
    BlockJacobi fewer (the reference's bar); from zero, ILU0 still takes fewer
    than Jacobi (here a third: 59 against 177; node-block Jacobi takes as
    many as Jacobi, and SGS two thirds, in both packages)."""
    sj, sp, _ = lsfem_pair
    its = {}
    for name in ("Jacobi", "BlockJacobi", "SGS", "ILU0"):
        if start == "zero" or name == "Jacobi":
            sp.set_solution_vector(torch.zeros_like(sp.x))
            sj.x = jnp.zeros_like(sj.x)
        res = sp.solve(lp.CG(lp.IterSolverOpts(tol=1e-10, max_iters=20000), precond=getattr(lp, name)()))
        assert res.converged and res.tol < 1e-9, (name, res)
        its[name] = res.num_iters
        with xla_optimizations(True):
            rj = sj.solve(lt.CG(lt.IterSolverOpts(tol=1e-10, max_iters=20000), precond=getattr(lt, name)()))
        assert abs(res.num_iters - rj.num_iters) <= 1, (name, res.num_iters, rj.num_iters)
    if start == "previous":
        assert its["ILU0"] * 3 <= its["Jacobi"] and its["SGS"] * 3 <= its["Jacobi"], its
        assert its["BlockJacobi"] < its["Jacobi"], its
    assert its["ILU0"] < its["Jacobi"], its


def test_assembled_preconditioners_reject_matrix_free():
    """The preconditioners that need the CSR name the strategy to use."""
    mesh = lp.generate_mesh(lp.make_square_mesh(np.linspace(0.0, 1.0, 3)), order=2)
    mf = lp.AlgebraicSystemParams(eval_strategy=lp.OperatorEvaluationStrategy.MATRIX_FREE)
    s = lp.make_algebraic_system(mesh, lp.ProblemDefinition(1, [0]), None, mf, dtype=torch.float64, device="cpu")
    for pc in (lp.BlockJacobi(), lp.SGS(), lp.ILU0(), lp.ILUT()):
        with pytest.raises(ValueError, match="GLOBAL_ASSEMBLY"):
            pc.setup_parts(s)
