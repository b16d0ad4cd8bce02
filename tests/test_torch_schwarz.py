"""The port's distributed preconditioners against the JAX package's.

In f64 on the CPU, on the assembled 2D diffusion problem of
``tests/test_schwarz.py`` (3x3 quads of order 2) at 2 and 4 shards: the
additive-Schwarz SGS, ILU(0) and ILUT with ``overlap`` 0 and 1 (per-shard
local solves on each shard's block of the gathered CSR), SGS with two
sweeps, Jacobi with sweeps and Chebyshev (from the same power-iteration
start vector) on the stacked layout: one apply within 1e-11 of the
reference's, with its ghost and dump slots zero, and CG (GMRES for ILUT)
within one iteration of the reference's, the solution within 1e-10.
BlockJacobi, which the reference does not take on a distributed system,
is held to the port's single-device BlockJacobi: the same iterations and
solution.  Each case runs on the port's shards stacked in one group and
placed with ``devices=["cpu"] * P`` (one placement group a shard).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import l3ster_tpu as lt
import l3ster_tpu_torch as lp
from l3ster_tpu_torch.solve import precond as pp
from tests.test_torch_distributed import (
    SHARDS_24,
    _ids,
    _off_owned_zero,
    _stacked_x,
    _zero_solutions,
    build_single,
    pair,
)
from tests.test_torch_system import _rel
from tests.torch_reference_fixtures import fast_reference_compiles, jitted_shard_maps, per_test_limit  # noqa: F401 (fixtures)

APPLY_TOL = 1e-11


@pytest.fixture(scope="module", autouse=True)
def same_start():
    """The reference's Chebyshev starts from the port's start vector."""

    def normal(key, shape, dtype=None):
        n = int(np.prod(shape))
        return jnp.asarray(pp.chebyshev_start(n, torch.float64, "cpu").numpy().reshape(shape), dtype)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "normal", normal)
    yield
    mp.undo()


PRECONDS = [
    ("sgs-0", lambda pkg: pkg.SGS(overlap=0), "cg"),
    ("sgs-1", lambda pkg: pkg.SGS(overlap=1), "cg"),
    ("sgs-2sweeps", lambda pkg: pkg.SGS(sweeps=2), "cg"),
    ("ilu0-0", lambda pkg: pkg.ILU0(overlap=0), "cg"),
    ("ilu0-1", lambda pkg: pkg.ILU0(overlap=1), "cg"),
    ("ilut-0", lambda pkg: pkg.ILUT(overlap=0), "gmres"),
    ("ilut-1", lambda pkg: pkg.ILUT(overlap=1), "gmres"),
    ("jacobi-2sweeps", lambda pkg: pkg.Jacobi(sweeps=2, damping=0.8), "cg"),
    ("chebyshev", lambda pkg: pkg.Chebyshev(), "cg"),
]


def _solver(pkg, kind, precond):
    if kind == "cg":
        return pkg.CG(pkg.IterSolverOpts(tol=1e-12, max_iters=3000), precond=precond)
    return pkg.Gmres(pkg.IterSolverOpts(tol=1e-12, max_iters=600, restart=40), precond=precond)


@pytest.mark.parametrize("n_shards,placed", SHARDS_24, ids=_ids(SHARDS_24))
@pytest.mark.parametrize("name,make,kind", PRECONDS, ids=[p[0] for p in PRECONDS])
def test_distributed_precond_matches_reference(n_shards, placed, name, make, kind):
    _, sj, sp_ = pair(n_shards, assembled=True, placed=placed)
    r = _stacked_x(sp_, 11)
    fj, cj = make(lt).setup_parts(sj)
    fp, cp = make(lp).setup_parts(sp_)
    z = fp(torch.as_tensor(r), *cp)
    assert _rel(z, jax.jit(fj)(jnp.asarray(r), *cj)) < APPLY_TOL
    assert _off_owned_zero(sp_, z)
    _zero_solutions(sj, sp_)
    rj = sj.solve(_solver(lt, kind, make(lt)))
    rp = sp_.solve(_solver(lp, kind, make(lp)))
    assert rp.converged and abs(rp.num_iters - rj.num_iters) <= 1, (rp.num_iters, rj.num_iters)
    assert np.abs(sp_.x.numpy() - np.asarray(sj.x)).max() < 1e-10


@pytest.mark.parametrize("n_shards,placed", SHARDS_24, ids=_ids(SHARDS_24))
def test_blockjacobi_matches_single_device(n_shards, placed):
    """Each node's block lives on the shard owning the node: CG + BlockJacobi
    takes the single-device iterations and solution."""
    mesh, _, sp_ = pair(n_shards, assembled=True, placed=placed)
    single = build_single(mesh)
    kdir = lp.wrap_boundary_residual_kernel(
        lambda i, o: o.__setitem__(0, i.point.x), lp.KernelParams(dimension=2, n_equations=1)
    )
    single.set_dirichlet_bc_values(kdir, [3, 4], [0])
    sp_.set_solution_vector(sp_.x * 0)
    r1 = single.solve(_solver(lp, "cg", lp.BlockJacobi()))
    rp = sp_.solve(_solver(lp, "cg", lp.BlockJacobi()))
    assert rp.converged and rp.num_iters == r1.num_iters, (rp.num_iters, r1.num_iters)
    assert np.abs(sp_._solution_global() - single.x.numpy()).max() < 1e-10
    assert _off_owned_zero(sp_, sp_.x)


def test_schwarz_needs_assembly():
    _, _, sp_ = pair(2)
    with pytest.raises(ValueError, match="GLOBAL_ASSEMBLY"):
        lp.SGS().setup_parts(sp_)
