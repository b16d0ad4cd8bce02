"""The port's PMultigrid and the solve layer of the Karman stepping against the JAX package.

In f64 on the CPU, on the reference tests' small mesh
(``tests/test_pmg.py:_cyl_mesh(order=2)``) with the BDF2 Navier-Stokes
operator reading four seeded fields (``tests/test_torch_fields.py``), matrix-free
(the reference forced to DENSE_MXU, the port's AUTO): ``extract_q1_mesh``
and the Q1 transfers exactly, one V-cycle from the same power-iteration
start vector (the reference's ``jax.random.normal`` is handed the port's
``_power_start`` vector), CG + PMultigrid, the ``lag="auto"`` refresh steps
over a 4-step BDF2 run, and CG's chunked warm restarts.  The reference's
matrix-free system is built once per module, and every test takes one
PMultigrid configuration (``PMG``), so the reference's Q1 level and its
solve programs are built once and a setup of one assembly serves every
test of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import l3ster_tpu as lt
import l3ster_tpu_torch as lp
from l3ster_tpu.mesh.convert_order import extract_q1_mesh as q1j
from l3ster_tpu.solve import pmg as pmgj
from l3ster_tpu.solve.krylov import _precond_parts as parts_j
from l3ster_tpu_torch.solve import lowordermg as mgp
from l3ster_tpu_torch.solve import pmg as pmgp
from l3ster_tpu_torch.solve.krylov import _precond_parts as parts_p
from tests.test_torch_fields import (  # noqa: F401  (module fixtures)
    assemble,
    flow_fields,
    managers,
    meshes,
    mf_pair,
)
from tests.test_torch_system import _rel, jax_run
from tests.torch_reference_fixtures import fast_reference_compiles, per_test_limit  # noqa: F401 (fixtures)

# one configuration for every test (see the module doc); the refresh ratio
# is :func:`test_lag_auto_refreshes_match_reference`'s
PMG = dict(lag="auto", refresh_ratio=1.2)


@pytest.fixture(scope="module", autouse=True)
def same_start():
    """The reference's power iteration starts from the port's start vector."""

    def normal(key, shape, dtype=None):
        level = int(np.asarray(key)[-1])
        return jnp.asarray(mgp._power_start(level, shape[0], torch.float64, "cpu").numpy(), dtype)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "normal", normal)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def ns_pair(meshes, mf_pair):
    """The BDF2 operator from seeded fields, matrix-free, in both packages,
    with their managers."""
    mesh, pmesh = meshes
    mj, mp = managers(mesh, pmesh, flow_fields(mesh, 11))
    sj, sp = mf_pair
    assemble(lt, sj, mj, [0, 1, 2, 3], transient=True, local_strategy="DENSE_MXU")
    assemble(lp, sp, mp, [0, 1, 2, 3], transient=True)
    return sj, sp, mj, mp


def test_extract_q1_mesh_and_transfers_match_reference(meshes):
    """The Q1 mesh (corner nodes, coordinates, every block and boundary view),
    the corner weights and the prolongation stencil, exactly."""
    mesh, pmesh = meshes
    m1j, idj = q1j(mesh)
    m1p, idp = lp.extract_q1_mesh(pmesh)
    np.testing.assert_array_equal(idp, idj)
    np.testing.assert_array_equal(m1p.node_coords, m1j.node_coords)
    assert sorted(m1p.domains) == sorted(m1j.domains) and m1p.boundary_ids == m1j.boundary_ids
    for did in m1j.domains:
        for bp, bj in zip(m1p.domains[did], m1j.domains[did], strict=True):
            assert bp.order == bj.order == 1
            np.testing.assert_array_equal(bp.nodes, bj.nodes)
            np.testing.assert_array_equal(bp.vertices, bj.vertices)
    for bid in m1j.boundary_ids:
        for vp, vj in zip(m1p.boundary_views[bid], m1j.boundary_views[bid], strict=True):
            assert vp.side == vj.side
            np.testing.assert_array_equal(vp.element_indices, vj.element_indices)
    ref = np.random.default_rng(12).uniform(-1, 1, size=(9, 2))
    np.testing.assert_array_equal(pmgp._q1_weights(ref), pmgj._q1_weights(ref))
    remap = np.full(mesh.n_nodes, -1, dtype=np.int64)
    remap[idj] = np.arange(len(idj))
    for a, b in zip(pmgp._build_transfers(pmesh, remap), pmgj._build_transfers(mesh, remap), strict=True):
        np.testing.assert_array_equal(a, b)


def test_vcycle_matches_reference(ns_pair):
    """One V-cycle of PMultigrid on the BDF2 operator (the coarse level
    replays it with the fields restricted to the corner nodes) from the same
    power-iteration start, to 1e-10.  The setups go through the solvers'
    per-epoch caches, which the CG tests reuse."""
    sj, sp, _, _ = ns_pair
    aj, cj = parts_j(lt.PMultigrid(**PMG), sj, "dof")
    ap, cp = parts_p(lp.PMultigrid(**PMG), sp, "dof")
    assert cp[-1].shape == (sp._pmg_static_cache[lp.PMultigrid(**PMG)]["s1"].n_dofs,) * 2
    r = np.random.default_rng(13).normal(size=(sj.n_dofs, 1))
    assert _rel(ap(torch.as_tensor(r), *cp), jax_run(aj, r, *cj)) < 1e-10


@pytest.mark.parametrize("chunk", [0, 10])
def test_cg_pmg_matches_reference(ns_pair, chunk):
    """CG + PMultigrid on the BDF2 operator from zero: iterations within 1 of
    the reference's, x within 1e-8 of it, and at most a quarter of CG +
    Jacobi's iterations (the reference's bar, ``tests/test_pmg.py``); with
    ``chunk`` warm restarts (each drops the conjugate direction), the same
    iteration count as the reference's."""
    sj, sp, _, _ = ns_pair
    opts = dict(tol=1e-8, max_iters=4000, chunk=chunk)
    sj.set_solution_vector(sj.x * 0)
    sp.set_solution_vector(sp.x * 0)
    rj = sj.solve(lt.CG(lt.IterSolverOpts(**opts), precond=lt.PMultigrid(**PMG)))
    rp = sp.solve(lp.CG(lp.IterSolverOpts(**opts), precond=lp.PMultigrid(**PMG)))
    assert rp.converged and abs(rp.num_iters - rj.num_iters) <= (1 if chunk == 0 else 0), (rp.num_iters, rj.num_iters)
    assert np.abs(sp.x.numpy() - np.asarray(sj.x)).max() < 1e-8
    if chunk == 0:
        sp.set_solution_vector(sp.x * 0)
        rjac = sp.solve(lp.CG(lp.IterSolverOpts(**opts), precond=lp.Jacobi()))
        assert 4 * rp.num_iters <= rjac.num_iters, (rp.num_iters, rjac.num_iters)


def test_lag_auto_refreshes_match_reference(meshes, ns_pair):
    """Four BDF2 steps with CG + PMultigrid(lag="auto") from zero, then from
    the predictor start, on the module's systems after the tests above: the
    same steps refresh the preconditioner in both packages, and the
    iterations per step agree within 1.  ``PMG``'s ``refresh_ratio=1.2`` puts the
    second step's count (37) well past 1.2 x the first's (27-28) and the
    fourth's below 1.2 x the third's, so a difference of one iteration
    between the packages cannot move a refresh."""
    sj, sp, _, _ = ns_pair
    mesh, pmesh = meshes
    mj, mp = managers(mesh, pmesh, flow_fields(mesh, 14))
    runs = []
    for pkg, system, manager in ((lt, sj, mj), (lp, sp, mp)):
        pmg = pkg.PMultigrid(**PMG)
        solver = pkg.CG(pkg.IterSolverOpts(tol=1e-8, max_iters=4000), precond=pmg)
        system.set_solution_vector(system.x * 0)
        vel1, vel2, x_prev, rec = [0, 1], [2, 3], None, []
        for _ in range(4):
            strategy = "DENSE_MXU" if pkg is lt else None
            assemble(pkg, system, manager, vel1 + vel2, transient=True, local_strategy=strategy)
            x_cur = system.solution_vector()
            if x_prev is not None:
                system.set_solution_vector(2.0 * x_cur - x_prev)
            x_prev = x_cur
            r = system.solve(solver)
            system.update_solution([0, 1, 2, 3], manager, vel2 + [4, 5])
            vel1, vel2 = vel2, vel1
            rec.append((r.num_iters, system._precond_auto[id(pmg)]["epoch"]))
        runs.append(rec)
    (ij, ej), (ip, ep) = zip(*runs[0]), zip(*runs[1])
    assert ep == ej and len(set(ej)) == 2, (runs[1], runs[0])
    assert max(abs(a - b) for a, b in zip(ip, ij)) <= 1, (ip, ij)


def test_pmg_rejects_oversized_coarse(ns_pair):
    """A coarse level above ``coarse_max_dofs`` raises, as the reference's."""
    _, sp, _, _ = ns_pair
    with pytest.raises(ValueError, match="coarse_max_dofs"):
        lp.PMultigrid(coarse_max_dofs=10).setup_parts(sp)
