"""The port's distributed PMultigrid against the JAX package's.

In f64 on the CPU, on the reference tests' small cylinder mesh
(``tests/test_pmg.py:_cyl_mesh(order=2)``, 288 quads at p = 2), at 2 and 4
shards: 2D diffusion with T = x on the inlet, outlet and cylinder
(``tests/test_pmg.py:_build_diffusion``), and the BDF2 Navier-Stokes
operator reading four seeded fields (``tests/test_torch_fields.py``; the
field-coupled ``dense`` kind, the reference forced to DENSE_MXU).  One
V-cycle from the same power-iteration start vector (the reference's
``jax.random.normal`` is handed the port's ``_power_start`` vector, shaped
``(n_shards, n_loc1, 1)``) within 1e-10; CG + PMultigrid within one iteration
of the reference's, the solution within 1e-10, and within the reference's
bar of the single-device solve; the Navier-Stokes apply and effective rhs
within 1e-11.  The diffusion case also runs on the port's shards placed with
``devices=["cpu"] * P`` (one placement group a shard), against the same
reference results.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import l3ster_tpu as lt
import l3ster_tpu_torch as lp
from l3ster_tpu.parallel.distributed import make_distributed_system as make_j
from l3ster_tpu.solve.krylov import _precond_parts as parts_j
from l3ster_tpu_torch.solve import lowordermg as mgp
from l3ster_tpu_torch.solve.krylov import _precond_parts as parts_p
from tests.test_pmg import _adiabatic_bc, _cyl_mesh, _diffusion_kernel_2d
from tests.test_torch_distributed import SHARDS_24, _ids, _off_owned_zero
from tests.test_torch_fields import assemble, flow_fields, managers
from tests.test_torch_system import _port_mesh, _rel, jax_run
from tests.torch_reference_fixtures import fast_reference_compiles, jitted_shard_maps, per_test_limit  # noqa: F401 (fixtures)

DOMAIN, BOTTOM, TOP, INLET, OUTLET, CYLINDER = 0, 1, 2, 3, 4, 5


@pytest.fixture(scope="module", autouse=True)
def same_start():
    """The reference's power iterations start from the port's start vectors."""

    def normal(key, shape, dtype=None):
        try:
            level = int(np.asarray(key)[-1])
        except jax.errors.TracerArrayConversionError:  # drawn inside a jitted setup: PRNGKey(0)
            level = 0
        v = mgp._power_start(level, int(np.prod(shape[:-1])), torch.float64, "cpu").numpy()
        return jnp.asarray(v.reshape(shape), dtype)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "normal", normal)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def meshes():
    mesh = _cyl_mesh(order=2)
    return mesh, _port_mesh(mesh)


def _make(pkg, mesh, n_shards, problem, bcs, placed=False):
    params = pkg.AlgebraicSystemParams(eval_strategy=pkg.OperatorEvaluationStrategy.MATRIX_FREE)
    if pkg is lt:
        return make_j(mesh, problem, bcs, params, n_shards=n_shards)
    if n_shards == 0:
        return lp.make_algebraic_system(mesh, problem, bcs, params, dtype=torch.float64, device="cpu")
    return lp.make_distributed_system(
        mesh, problem, bcs, params, n_shards=n_shards, dtype=torch.float64, device="cpu",
        devices=["cpu"] * n_shards if placed else None,
    )


def diffusion(pkg, mesh, n_shards, placed=False):
    """``tests/test_pmg.py:_build_diffusion`` on ``n_shards`` shards (0: the
    port's single system), ``placed`` on as many "cpu" entries."""
    problem = pkg.ProblemDefinition(3, [DOMAIN])
    bcs = pkg.BCDefinition(problem)
    bcs.define_dirichlet([INLET, OUTLET, CYLINDER], [0])
    system = _make(pkg, mesh, n_shards, problem, bcs, placed)
    kd = pkg.wrap_domain_equation_kernel(_diffusion_kernel_2d, pkg.KernelParams(dimension=2, n_equations=4, n_unknowns=3))
    kn = pkg.wrap_boundary_equation_kernel(_adiabatic_bc, pkg.KernelParams(dimension=2, n_equations=1, n_unknowns=3))
    kdir = pkg.wrap_boundary_residual_kernel(lambda i, o: o.__setitem__(0, i.point.x), pkg.KernelParams(dimension=2, n_equations=1))
    strat = dict(eval_strategy=lt.LocalEvalStrategy.DENSE_MXU) if pkg is lt else {}
    system.set_dirichlet_bc_values(kdir, [INLET, OUTLET, CYLINDER], [0])
    system.begin_assembly()
    system.assemble_problem(kd, [DOMAIN], options=pkg.AssemblyOptions(value_order=1, derivative_order=0, **strat))
    system.assemble_problem(kn, [BOTTOM, TOP])
    system.end_assembly()
    return system


PMG = dict(smooth_degree=2)
CG_OPTS = dict(tol=1e-10, max_iters=4000)


_REF: dict = {}


def _reference_diffusion(mesh, pmesh, n_shards):
    """The reference's V-cycle apply and CG + PMultigrid solve, and the port's
    single-device solve, once per shard count: (r, z, iterations, x, single
    iterations, single x)."""
    if n_shards not in _REF:
        sj = diffusion(lt, mesh, n_shards)
        fj, cj = parts_j(lt.PMultigrid(**PMG), sj, "dof")
        r = np.array(sj.effective_rhs())
        z = np.asarray(jax_run(fj, r, *cj))
        rj = sj.solve(lt.CG(lt.IterSolverOpts(**CG_OPTS), precond=lt.PMultigrid(**PMG)))
        s1 = diffusion(lp, pmesh, 0)
        r1 = s1.solve(lp.CG(lp.IterSolverOpts(**CG_OPTS), precond=lp.PMultigrid(**PMG)))
        _REF[n_shards] = (r, z, rj.num_iters, np.asarray(sj.x), r1.num_iters, s1.x.numpy())
    return _REF[n_shards]


@pytest.mark.parametrize("n_shards,placed", SHARDS_24, ids=_ids(SHARDS_24))
def test_pmg_diffusion_matches_reference(meshes, n_shards, placed):
    mesh, pmesh = meshes
    r, zj, it_j, xj, it_1, x1 = _reference_diffusion(mesh, pmesh, n_shards)
    sp_ = diffusion(lp, pmesh, n_shards, placed)
    fp, cp = parts_p(lp.PMultigrid(**PMG), sp_, "dof")
    z = fp(torch.as_tensor(r), *cp)
    assert _rel(z, zj) < 1e-10
    assert _off_owned_zero(sp_, z)
    rp = sp_.solve(lp.CG(lp.IterSolverOpts(**CG_OPTS), precond=lp.PMultigrid(**PMG)))
    assert rp.converged and abs(rp.num_iters - it_j) <= 1, (rp.num_iters, it_j)
    assert np.abs(sp_.x.numpy() - xj).max() < 1e-10
    assert abs(rp.num_iters - it_1) <= max(3, int(0.05 * it_1)), (rp.num_iters, it_1)
    assert np.abs(sp_._solution_global() - x1).max() < 1e-7
    X = sp_._solution_global()[:, 0].reshape(-1, 3)
    assert np.abs(X[:, 0] - mesh.node_coords[:, 0]).max() < 1e-7


def karman_distributed(pkg, mesh, n_shards):
    """``tests/test_torch_fields.py:karman_system`` on ``n_shards`` shards."""
    H = float(np.max(mesh.node_coords[:, 1]))
    problem = pkg.ProblemDefinition(4, [DOMAIN])
    bcs = pkg.BCDefinition(problem)
    bcs.define_dirichlet([INLET, BOTTOM, TOP, CYLINDER], [0, 1])
    system = _make(pkg, mesh, n_shards, problem, bcs)

    def prof(i, o):
        o[0] = 1.5 * (1.0 - (i.point.y / H) ** 2)
        o[1] = 0.0

    ki = pkg.wrap_boundary_residual_kernel(prof, pkg.KernelParams(dimension=2, n_equations=2))
    system.set_dirichlet_bc_values([0.0, 0.0], [BOTTOM, TOP, CYLINDER], [0, 1])
    system.set_dirichlet_bc_values(ki, [INLET], [0, 1])
    return system


def test_navier_stokes_pmg_matches_reference(meshes):
    """The BDF2 operator reading fields on 4 shards: apply, diagonal and
    effective rhs within 1e-11; CG + PMultigrid(lag="auto") within one
    iteration, the solution within 1e-10; the nodal update into the manager."""
    mesh, pmesh = meshes
    mj, mp = managers(mesh, pmesh, flow_fields(mesh, 11))
    sj, sp_ = karman_distributed(lt, mesh, 4), karman_distributed(lp, pmesh, 4)
    assemble(lt, sj, mj, [0, 1, 2, 3], transient=True, local_strategy="DENSE_MXU")
    assemble(lp, sp_, mp, [0, 1, 2, 3], transient=True)
    assert [d[0] for _, d, _ in sp_._operators()][:1] == ["dense"]
    x = np.random.default_rng(3).normal(size=(sp_.n_shards, sp_.n_loc1, 1)) * sp_._owned_mask.numpy()[:, :, None]
    fj, cj = sj.operator_parts()
    fp, cp = sp_.operator_parts()
    assert _rel(fp(torch.as_tensor(x), *cp), jax_run(fj, x, *cj)) < 1e-11
    assert _rel(sp_.diagonal(), sj.diagonal()) < 1e-11
    assert _rel(sp_.effective_rhs(), sj.effective_rhs()) < 1e-11
    pj, pp_ = lt.PMultigrid(lag="auto"), lp.PMultigrid(lag="auto")
    rj = sj.solve(lt.CG(lt.IterSolverOpts(tol=1e-9, max_iters=2000), precond=pj))
    rp = sp_.solve(lp.CG(lp.IterSolverOpts(tol=1e-9, max_iters=2000), precond=pp_))
    assert rp.converged and abs(rp.num_iters - rj.num_iters) <= 1, (rp.num_iters, rj.num_iters)
    assert np.abs(sp_.x.numpy() - np.asarray(sj.x)).max() < 1e-10
    sj.update_solution([0, 1], mj, [0, 1])
    sp_.update_solution([0, 1], mp, [0, 1])
    assert np.abs(mp.values.numpy() - np.asarray(mj.values)).max() < 1e-10
