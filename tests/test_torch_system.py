"""The port's matrix-free system against the JAX package on the bench configuration.

3D diffusion (4 unknowns, 7 equations, constant coefficients) on a 2^3-hex
cube at p = 2 and 3, value-only adiabatic faces on sides 1-4 and Dirichlet T on sides 5-6,
in f64 on the CPU, also under each of the reference's opt-in lattice pipelines
(``L3STER_TPU_ZSWEEP=v1``, ``L3STER_TPU_XY_PALLAS=1``).  One mesh feeds both packages through
``l3ster_tpu_torch.interop.mesh_from_numpy``.  The reference runs with
``LocalEvalStrategy.LATTICE_SF`` forced (its AUTO picks the lattice path
only on a TPU); the port takes the lattice path by default.  Tolerances are
the reference's own oracle tolerances (test_lattice_sf.py).
"""

import numpy as np
import pytest
import torch

import l3ster_tpu as lt
import l3ster_tpu_torch as lp
from bench import _adiabatic_3d, _diffusion_3d
from tests.torch_reference_fixtures import fast_reference_compiles, per_test_limit, xla_optimizations  # noqa: F401 (fixtures)

REL = 1e-11  # operator apply / diagonal / effective rhs, relative to max |reference|


def _diffusion_src(inp, out):
    _diffusion_3d(inp, out)
    _, rhs = out
    rhs[0] = 1.0  # a constant source, so the rhs pass has work
    rhs[5] = 0.5


def _port_mesh(mesh):
    return lp.mesh_from_numpy(
        mesh.dim,
        mesh.n_nodes,
        mesh.node_coords,
        {
            did: [(b.element_type.name, b.order, b.nodes, b.vertices) for b in blks]
            for did, blks in mesh.domains.items()
        },
        mesh.boundary_ids,
    )


def _build(pkg, mesh, kernel, n_rhs=1):
    problem = pkg.ProblemDefinition(4, [0])
    bcs = pkg.BCDefinition(problem)
    bcs.define_dirichlet([5, 6], [0])
    params = pkg.AlgebraicSystemParams(
        eval_strategy=pkg.OperatorEvaluationStrategy.MATRIX_FREE, n_rhs=n_rhs
    )
    kp = dict(n_rhs=n_rhs)
    kd = pkg.wrap_domain_equation_kernel(kernel, pkg.KernelParams(3, 7, 4, **kp))
    kn = pkg.wrap_boundary_equation_kernel(_adiabatic_3d, pkg.KernelParams(3, 1, 4, **kp))
    if pkg is lt:
        system = lt.make_algebraic_system(mesh, problem, bcs, params)
        opts = lt.AssemblyOptions(eval_strategy=lt.LocalEvalStrategy.LATTICE_SF)
    else:
        system = lp.make_algebraic_system(
            _port_mesh(mesh), problem, bcs, params, dtype=torch.float64, device="cpu"
        )
        opts = lp.AssemblyOptions()
    system.set_dirichlet_bc_values([0.0], [5], [0])
    system.set_dirichlet_bc_values([1.0], [6], [0])
    system.begin_assembly()
    system.assemble_problem(kd, [0], options=opts)
    system.assemble_problem(kn, [1, 2, 3, 4])
    system.end_assembly()
    return system


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def jax_run(fn, *args):
    """fn(*args) of the reference, jitted: its eager op-by-op dispatch costs seconds."""
    import jax

    return jax.jit(fn)(*args)


def _jax_apply(system, x, layout="dof"):
    """The reference operator, run through :func:`jax_run`."""
    fn, consts = system.operator_parts(layout=layout)
    return jax_run(fn, x, *consts)


def _mesh(order):
    return lt.generate_mesh(lt.make_cube_mesh(np.linspace(0.0, 1.0, 3)), order=order)


@pytest.fixture(scope="module")
def bench_pair():
    """The p=2 bench system in both packages (built once: the reference's
    operator setup costs seconds)."""
    mesh = _mesh(2)
    return mesh, _build(lt, mesh, _diffusion_3d), _build(lp, mesh, _diffusion_3d)


def _check_operator(sj, sp, n_rhs):
    assert sp.n_dofs == sj.n_dofs
    np.testing.assert_array_equal(sp.dirichlet_dofs, sj.dirichlet_dofs)
    assert sp.lattice_layout_key() == sj.lattice_layout_key()
    kinds = [d[0] for _, d in sp._operators()[1]]
    assert kinds == ["lattice_sf_const_diag"] + ["face_banded"] * 4
    x = np.random.default_rng(n_rhs).normal(size=(sj.n_dofs, n_rhs))
    xt = torch.as_tensor(x)
    y_lat = _jax_apply(sj, sj.to_lattice_layout(x), "lattice")
    fp, cp = sp.operator_parts(layout="lattice")
    assert _rel(fp(sp.to_lattice_layout(xt), *cp), y_lat) < REL
    assert _rel(sp.operator()(xt), sj.from_lattice_layout(y_lat)) < REL
    assert _rel(sp.diagonal(), sj.diagonal()) < REL
    assert _rel(sp.effective_rhs(), sj.effective_rhs()) < REL


def test_operator_diagonal_rhs_match_reference(bench_pair):
    """p=2: operator apply in both layouts, diagonal and effective rhs."""
    _, sj, sp = bench_pair
    _check_operator(sj, sp, 1)


def test_multi_rhs_with_source_matches_reference():
    """p=3, two rhs columns riding the lattice apply as 8 stacked channels,
    and a constant source so the rhs pass has work."""
    mesh = _mesh(3)
    sj = _build(lt, mesh, _diffusion_src, n_rhs=2)
    sp = _build(lp, mesh, _diffusion_src, n_rhs=2)
    _check_operator(sj, sp, 2)
    assert _rel(sp.rhs, sj.rhs) < REL


def test_cg_jacobi_solve_matches_reference(bench_pair):
    """T = x, q = (1, 0, 0): CG + Jacobi iteration counts within 1 of the
    reference, solutions within 1e-10, and the exact solution recovered."""
    mesh, sj, sp = bench_pair
    opts = dict(tol=1e-12, max_iters=2000)
    rj = sj.solve(lt.CG(lt.IterSolverOpts(**opts), precond=lt.Jacobi()))
    rp = sp.solve(lp.CG(lp.IterSolverOpts(**opts), precond=lp.Jacobi()))
    assert rp.converged and not rp.capped and rp.tol <= 1e-12
    assert abs(rp.num_iters - rj.num_iters) <= 1, (rp.num_iters, rj.num_iters)
    xp = sp.x.numpy()
    assert np.abs(xp - np.asarray(sj.x)).max() < 1e-10
    X = xp[:, 0].reshape(-1, 4)
    assert np.abs(X[:, 0] - mesh.node_coords[:, 0]).max() < 1e-10
    assert np.abs(X[:, 1] - 1.0).max() < 1e-10 and np.abs(X[:, 2:]).max() < 1e-10


def test_generate_mesh_matches_reference():
    """The port's own host layer builds the reference's mesh, node for node."""
    mj = _mesh(3)
    mp = lp.generate_mesh(lp.make_cube_mesh(np.linspace(0.0, 1.0, 3)), order=3)
    np.testing.assert_array_equal(mp.node_coords, mj.node_coords)
    for did in mj.domains:
        for bj, bp in zip(mj.domains[did], mp.domains[did]):
            np.testing.assert_array_equal(bp.nodes, bj.nodes)
    for bid in mj.boundary_ids:
        assert [v.side for v in mp.boundary_views[bid]] == [v.side for v in mj.boundary_views[bid]]


def test_default_device_is_cuda():
    """Without a device the system goes to CUDA, and raises rather than fall
    back to the CPU when there is none."""
    mesh = lp.generate_mesh(lp.make_cube_mesh(np.linspace(0.0, 1.0, 2)), order=1)
    problem = lp.ProblemDefinition(4, [0])
    params = lp.AlgebraicSystemParams(eval_strategy=lp.OperatorEvaluationStrategy.MATRIX_FREE)
    if torch.cuda.is_available():
        assert lp.make_algebraic_system(mesh, problem, None, params).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            lp.make_algebraic_system(mesh, problem, None, params)


@pytest.mark.parametrize(
    "env,value,kind",
    [("L3STER_TPU_ZSWEEP", "v1", "lattice_sf_const"), ("L3STER_TPU_XY_PALLAS", "1", "lattice_sf_const_diag")],
)
def test_system_under_switch_matches_default_and_reference(bench_pair, monkeypatch, env, value, kind):
    """The reference's opt-in lattice pipelines: the switch is read once, when
    the operator is built, so the apply keeps its pipeline after the variable
    is unset; it equals the default pipeline's and the reference's (v1 takes
    full geometry, so its kind is lattice_sf_const)."""
    mesh, sj, sp = bench_pair
    monkeypatch.setenv(env, value)
    s = _build(lp, mesh, _diffusion_3d)
    fn, consts = s.operator_parts(layout="lattice")
    monkeypatch.delenv(env)
    assert [d[0] for _, d in s._operators()[1]] == [kind] + ["face_banded"] * 4
    assert s._variant == {"v1": "v1", "1": "xy"}[value]
    x = np.random.default_rng(6).normal(size=(sj.n_dofs, 1))
    xl = torch.as_tensor(sj.to_lattice_layout(x))
    y = fn(xl, *consts)
    fd, cd = sp.operator_parts(layout="lattice")
    assert _rel(y, fd(xl, *cd)) < REL
    assert _rel(y, _jax_apply(sj, sj.to_lattice_layout(x), "lattice")) < REL
    assert _rel(s.effective_rhs(), sj.effective_rhs()) < REL


class _DiagSystem:
    """A 5 x 5 diagonal operator with the system interface CG uses."""

    def __init__(self):
        self.d = torch.arange(1.0, 6.0, dtype=torch.float64)
        self.b = torch.ones((5, 1), dtype=torch.float64)
        self.x = torch.zeros((5, 1), dtype=torch.float64)
        self._assembly_epoch = 1

    def lattice_layout_key(self):
        return None

    def operator_parts(self, layout="dof"):
        assert layout == "dof"
        return (lambda x: self.d[:, None] * x), ()

    def diagonal(self):
        return self.d

    def effective_rhs(self):
        return self.b

    def solution_vector(self):
        return self.x

    def set_solution_vector(self, x):
        self.x = x


class _SetupOnly:
    """A preconditioner in the reference's closure style: ``setup(system)`` only."""

    supports_lattice_layout = False

    def __init__(self):
        self.setups = 0

    def setup(self, system):
        self.setups += 1
        inv = 1.0 / system.diagonal()
        return lambda r: inv[:, None] * r


def test_cg_accepts_reference_preconditioner_protocol():
    """CG takes a preconditioner with only ``setup(self, system)`` (run in the
    dof layout, as the reference's ``_precond_parts`` does), reuses its setup
    for a second solve in the same assembly epoch, and sets it up again after
    the epoch moves."""
    system, pre = _DiagSystem(), _SetupOnly()
    cg = lp.CG(lp.IterSolverOpts(tol=1e-12, max_iters=10), precond=pre)
    r = cg.solve(system)
    assert r.converged and r.num_iters == 1 and pre.setups == 1
    np.testing.assert_allclose(system.x[:, 0].numpy(), 1.0 / np.arange(1.0, 6.0), rtol=1e-14)
    system.x = torch.zeros_like(system.x)
    assert cg.solve(system).converged and pre.setups == 1
    system._assembly_epoch += 1
    assert cg.solve(system).converged and pre.setups == 2


def test_precond_lag_buckets_epochs():
    """An integer ``lag = k`` reuses a setup for up to k reassemblies (epochs
    bucketed by k + 1); ``lag="auto"`` keeps a setup across reassemblies
    until a solve takes more than ``refresh_ratio`` times the iterations of
    the first solve after it, and then sets up again."""
    from l3ster_tpu_torch.solve.krylov import _note_precond_iters

    system, pre = _DiagSystem(), _SetupOnly()
    pre.lag = 1
    cg = lp.CG(lp.IterSolverOpts(tol=1e-12, max_iters=10), precond=pre)
    counts = []
    for epoch in (2, 3, 4, 5):
        system._assembly_epoch = epoch
        cg.solve(system)
        counts.append(pre.setups)
    assert counts == [1, 1, 2, 2]
    pre.lag = "auto"
    counts = []
    for epoch in (6, 7, 8, None, 9, 10):
        if epoch is None:
            _note_precond_iters(system, pre, 2)  # 2 > 1.35 x 1: stale
            continue
        system._assembly_epoch = epoch
        system.x = torch.zeros_like(system.x)
        assert cg.solve(system).num_iters == 1  # the baseline: one iteration
        counts.append(pre.setups)
    assert counts == [3, 3, 3, 4, 4]
