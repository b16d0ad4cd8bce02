"""The port's box decomposition and its LowOrderMG against the JAX package's.

In f64 on the CPU, on the bench configuration of ``tests/test_torch_system.py``
(3D diffusion, value-only adiabatic faces on sides 1-4, Dirichlet T on sides
5-6) at p = 2 on 3^3 hexes: z slabs at 2 and 4 shards (the 4-slab windows are
uneven, the last one empty) and (2, 2) and (2, 4) pencil grids (uneven on
both axes).  The window layouts exactly; the stacked box apply within 1e-11
of the reference's box apply and of the port's single-system apply, with its
ghost and padding planes zero; CG + Jacobi and CG + the box LowOrderMG (from
the same power-iteration start vector) within one iteration of the
reference's, the solution within 1e-10; and the apply of a sheared cube,
whose windows carry full per-QP Jacobians.  The port's shards are stacked in
one group, or placed with ``devices=["cpu"] * P`` (one placement group a
shard, the counterpart of the reference's virtual devices), with the same
bars.  The reference runs its volume kernel as LATTICE_SF (its AUTO takes the
lattice path only on a TPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import l3ster_tpu as lt
import l3ster_tpu_torch as lp
from bench import _diffusion_3d
from l3ster_tpu.parallel.box import box_parallelize as box_j
from l3ster_tpu.solve.krylov import _precond_parts as parts_j
from l3ster_tpu_torch.solve import lowordermg as mgp
from l3ster_tpu_torch.solve.krylov import _precond_parts as parts_p
from tests.test_torch_system import _build, _rel, jax_run
from tests.torch_reference_fixtures import fast_reference_compiles, jitted_shard_maps, per_test_limit  # noqa: F401 (fixtures)

REL = 1e-11
CASES = [(2, None, False), (4, None, False), (4, (2, 2), False), (8, (2, 4), False), (2, None, True), (4, (2, 2), True)]


def _ids(cases):
    return [f"{n}-{'x'.join(map(str, g)) if g else 'z'}{'-placed' if p else ''}" for n, g, p in cases]


@pytest.fixture(scope="module", autouse=True)
def same_start():
    """The reference's power iterations start from the port's start vectors."""

    def normal(key, shape, dtype=None):
        level = int(np.asarray(key)[-1])
        v = mgp._power_start(level, int(np.prod(shape[:-1])), torch.float64, "cpu").numpy()
        return jnp.asarray(v.reshape(shape), dtype)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "normal", normal)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def systems():
    """The single systems of both packages, built once."""
    mesh = lt.generate_mesh(lt.make_cube_mesh(np.linspace(0.0, 1.0, 4)), order=2)
    return mesh, _build(lt, mesh, _diffusion_3d), _build(lp, mesh, _diffusion_3d)


_BOXES: dict = {}


def boxes(systems, n_shards, grid, placed=False):
    """(reference box, port box), built once; one reference box serves the
    port's stacked and placed boxes."""
    _, sj, sp_ = systems
    if (n_shards, grid) not in _BOXES:
        _BOXES[(n_shards, grid)] = box_j(sj, n_shards=n_shards, grid=grid)
    if (n_shards, grid, placed) not in _BOXES:
        devices = ["cpu"] * n_shards if placed else None
        _BOXES[(n_shards, grid, placed)] = lp.box_parallelize(sp_, n_shards=n_shards, grid=grid, devices=devices)
    return _BOXES[(n_shards, grid)], _BOXES[(n_shards, grid, placed)]


@pytest.fixture(scope="module")
def sheared():
    """The bench problem on a sheared cube (x' = x + 0.3 y): the geometry is
    not axis-aligned, so the volume kernel takes full per-QP Jacobians
    (``lattice_sf_const``) in both packages."""
    mesh = lt.generate_mesh(lt.make_cube_mesh(np.linspace(0.0, 1.0, 4)), order=2)
    mesh.node_coords[:, 0] += 0.3 * mesh.node_coords[:, 1]  # after the lattice numbering
    for blks in mesh.domains.values():
        for blk in blks:
            blk.vertices[..., 0] += 0.3 * blk.vertices[..., 1]
    return _build(lt, mesh, _diffusion_3d), _build(lp, mesh, _diffusion_3d)


def _off_owned_zero(bp, v) -> bool:
    return bool((v.numpy()[bp._own_st.numpy() == 0] == 0).all())


@pytest.mark.parametrize("n_shards,grid,placed", CASES, ids=_ids(CASES))
def test_box_apply_matches_reference(systems, n_shards, grid, placed):
    _, sj, sp_ = systems
    bj, bp = boxes(systems, n_shards, grid, placed)
    assert len(bp._groups) == (n_shards if placed else 1)
    assert (bp._nez_real, bp._ney_real, bp._n1_loc) == (bj._nez_real, bj._ney_real, bj._n1_loc)
    xg = np.random.default_rng(n_shards).normal(size=(sj.n_dofs, 1))
    x_st = np.asarray(bj._to_slabs(xg))
    np.testing.assert_array_equal(bp._to_slabs(torch.as_tensor(xg)).numpy(), x_st)
    fj, cj = bj.operator_parts()
    y = bp.operator()(torch.as_tensor(x_st))
    assert _rel(y, jax_run(fj, x_st, *cj)) < REL
    assert _off_owned_zero(bp, y)
    assert _rel(bp._from_slabs(y), sp_.operator()(torch.as_tensor(xg))) < REL
    assert _rel(bp.diagonal(), bj.diagonal()) < REL and _rel(bp.effective_rhs(), bj.effective_rhs()) < REL
    if placed:  # each shard's window data and vector part on its group's device
        assert [t.shape[0] for t in y.parts] == [g.n for g in bp._groups]
        assert all(t.device == g.device for t, g in zip(y.parts, bp._groups))
        assert "shards 0" in bp.describe()


def _solve(box, pkg, precond):
    box.inner.set_solution_vector(box.inner.solution_vector() * 0)
    return box.solve(pkg.CG(pkg.IterSolverOpts(tol=1e-11, max_iters=3000), precond=precond))


@pytest.mark.parametrize("n_shards,grid", [(4, None), (4, (2, 2))])
def test_box_cg_jacobi_matches_reference(systems, n_shards, grid):
    bj, bp = boxes(systems, n_shards, grid)
    rj, rp = _solve(bj, lt, lt.Jacobi()), _solve(bp, lp, lp.Jacobi())
    assert rp.converged and abs(rp.num_iters - rj.num_iters) <= 1, (rp.num_iters, rj.num_iters)
    assert np.abs(bp.inner.x.numpy() - np.asarray(bj.inner.x)).max() < 1e-10


MG_CASES = [(4, None, False), (4, (2, 2), False), (8, (2, 4), False), (2, None, True), (4, (2, 2), True)]


@pytest.mark.parametrize("n_shards,grid,placed", MG_CASES, ids=_ids(MG_CASES))
def test_box_lowordermg_matches_reference(systems, n_shards, grid, placed):
    """One V-cycle within 1e-11, then CG + LowOrderMG: iterations within one
    of the reference's box solve and within two of the port's single-system
    solve (the reference's bar, ``tests/test_box.py``); solution within 1e-10,
    T = x recovered."""
    mesh, _, sp_ = systems
    bj, bp = boxes(systems, n_shards, grid, placed)
    r = np.array(bj.effective_rhs())
    # through the solvers' setup caches, which the CG solves below reuse
    fj, cj = parts_j(lt.LowOrderMG(), bj, "dof")
    fp, cp = parts_p(lp.LowOrderMG(), bp, "dof")
    z = fp(torch.as_tensor(r), *cp)
    assert _rel(z, jax_run(fj, r, *cj)) < REL
    rj, rp = _solve(bj, lt, lt.LowOrderMG()), _solve(bp, lp, lp.LowOrderMG())
    assert rp.converged and abs(rp.num_iters - rj.num_iters) <= 1, (rp.num_iters, rj.num_iters)
    x_box = bp.inner.x.numpy().copy()
    assert np.abs(x_box - np.asarray(bj.inner.x)).max() < 1e-10
    assert np.abs(x_box[:, 0].reshape(-1, 4)[:, 0] - mesh.node_coords[:, 0]).max() < 1e-8
    sp_.set_solution_vector(sp_.x * 0)  # the box's inner system: the single solve from zero
    r1 = sp_.solve(lp.CG(lp.IterSolverOpts(tol=1e-11, max_iters=3000), precond=lp.LowOrderMG()))
    assert abs(rp.num_iters - r1.num_iters) <= 2, (rp.num_iters, r1.num_iters)


def test_lowordermg_rejects_distributed_system():
    """The reference's rejection of LowOrderMG on a DistributedSystem, and its message."""
    from tests.test_torch_distributed import pair

    _, sj, sp_ = pair(2)
    with pytest.raises(ValueError) as ej:
        lt.LowOrderMG().setup_parts(sj)
    with pytest.raises(ValueError) as ep:
        lp.LowOrderMG().setup_parts(sp_)
    assert str(ep.value) == str(ej.value)


def test_box_describe(systems):
    bj, bp = boxes(systems, 4, (2, 2))
    tp, tj = bp.describe(per_shard=True).split("\n"), bj.describe(per_shard=True).split("\n")
    assert tp[1:] == tj[1:] and tp[0].startswith("BoxSystem: ")


@pytest.mark.parametrize("n_shards,grid", [(4, None), (4, (2, 2))])
def test_box_full_geometry_apply_matches_reference(sheared, n_shards, grid):
    """The box windows of full per-QP geometry (unit Jacobians on padding
    QPs) within 1e-11 of the reference's box apply and the single apply."""
    sj, sp_ = sheared
    assert sp_._operators()[1][0][1][0] == "lattice_sf_const"
    bj, bp = box_j(sj, n_shards=n_shards, grid=grid), lp.box_parallelize(sp_, n_shards=n_shards, grid=grid)
    xg = np.random.default_rng(9).normal(size=(sj.n_dofs, 1))
    x_st = np.asarray(bj._to_slabs(xg))
    fj, cj = bj.operator_parts()
    y = bp.operator()(torch.as_tensor(x_st))
    assert _rel(y, jax_run(fj, x_st, *cj)) < REL
    assert _rel(bp._from_slabs(y), sp_.operator()(torch.as_tensor(xg))) < REL
