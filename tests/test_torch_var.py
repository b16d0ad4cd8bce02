"""The port's variable-coefficient lattice path against the JAX package, f64 on the CPU.

The fused z-sweep's variable-coefficient mode (plain version) against the
reference's ``fused_z_sweep_v2(var=..., interpret=True)`` in both geometry
modes and both layouts; then the system: the bench's 3D diffusion kernel
with its conservation row scaled by k = 1 + x*y (the reference's oracle
kernel ``_var_3d``, tests/test_lattice_sf.py) with the bench's boundaries
(value-only adiabatic faces on sides 1-4, Dirichlet T = 0 and 1 on sides 5
and 6: T = x there), on a 2^3 hex cube at p = 2.  The port's AUTO takes ``lattice_sf_var``; the reference
runs ``LATTICE_SF`` (its AUTO takes the lattice only on a TPU).  The exact
solution stays T = x, q = (1, 0, 0).  Tolerances are the reference's own
(tests/test_lattice_sf.py).
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

import l3ster_tpu as lt
import l3ster_tpu_torch as lp
from tests.test_torch_system import _build, _jax_apply, _mesh, _port_mesh, _rel, jax_run
from tests.torch_reference_fixtures import fast_reference_compiles, per_test_limit  # noqa: F401 (fixtures)

REL = 1e-11  # apply / diagonal / rhs / kernel outputs, relative to max |reference|


def _var_diffusion(inp, out, scale=1.0):
    """The bench kernel with k(x, y) = 1 + x*y on its conservation row 0, all
    of A times ``scale``."""
    ops, rhs = out
    A0, Ax, Ay, Az = ops
    k = scale * (1.0 + inp.point.x * inp.point.y)
    Ax[0, 1] = Ay[0, 2] = Az[0, 3] = -k
    A0[1, 1] = A0[2, 2] = A0[3, 3] = -scale
    Ax[1, 0] = Ay[2, 0] = Az[3, 0] = scale
    Ay[4, 3], Az[4, 2] = scale, -scale
    Ax[5, 3], Az[5, 1] = -scale, scale
    Ax[6, 2], Ay[6, 1] = scale, -scale


@lru_cache(maxsize=None)
def _zsweep_var_case(p, ne, qo, mode):
    """Inputs of one case in the (c, n1z, RQ) layout, nonzero (d, i, u) planes
    of a spatially varying A (~60% structural zeros), and the reference's
    outputs on them: its Pallas kernel runs once per case, in its "cz" layout
    (its own test holds "zc" to "cz", tests/test_lattice_sf.py:259-264)."""
    import jax.numpy as jnp

    from l3ster_tpu.ops.pallas_zsweep2 import fused_z_sweep_v2
    from l3ster_tpu_torch.ops.lattice_sumfact import banded_tables
    from l3ster_tpu_torch.ops.zsweep import detect_diag_geometry

    q1 = qo // 2 + 1
    S = R = Q = ne * q1
    RQ, n1z, C = R * Q, ne * p + 1, 4
    rng = np.random.default_rng(p + 100)
    bs = [rng.normal(size=(C, n1z, RQ)) for _ in range(3)]
    mask = rng.uniform(size=(4, 7, C)) > 0.6
    nz = tuple(tuple(int(v) for v in ix) for ix in np.argwhere(mask))
    A_nz = rng.normal(size=(len(nz), S, RQ))
    if mode == "diag":
        Jd = np.zeros((3, 3, S, RQ))
        Jd[0, 0] = rng.uniform(0.5, 1.5, (1, RQ))
        Jd[1, 1] = rng.uniform(0.5, 1.5, (1, RQ))
        Jd[2, 2] = rng.uniform(0.5, 1.5, (S, 1))
        wd = rng.uniform(0.5, 1.0, (S, 1)) * rng.uniform(0.5, 1.0, (1, RQ))
        g = detect_diag_geometry(Jd.reshape(3, 3, -1), wd.reshape(-1), S)
    else:
        ji = rng.normal(size=(9, S, RQ)) * 0.1 + np.eye(3).reshape(9, 1, 1)
        g = ("full", ji, rng.uniform(0.5, 1.0, (S, RQ)))
    Ng, Dg = banded_tables(p, qo, ne)
    ref = jax_run(
        lambda A_nz, *x: fused_z_sweep_v2(
            None, *x[:3], (g[0],) + x[3:], jnp.asarray(Ng.T), jnp.asarray(Dg.T), block=256,
            interpret=True, host_tables=(Ng.T, Dg.T), var=(nz, A_nz, 7), layout="cz",
        ),
        jnp.asarray(A_nz), *(jnp.asarray(x) for x in bs + list(g[1:])),
    )
    return bs, nz, A_nz, g, Ng, Dg, tuple(np.asarray(r) for r in ref)


@pytest.mark.parametrize("layout", ["cz", "zc"])
@pytest.mark.parametrize("mode", ["diag", "full"])
@pytest.mark.parametrize("p,ne,qo", [(2, 3, 4), (4, 2, 10)])
def test_zsweep_var_plain_matches_pallas(p, ne, qo, mode, layout):
    """The plain z-sweep's variable mode in both layouts against the
    reference's Pallas kernel on the same inputs ("zc" compared transposed)."""
    from l3ster_tpu_torch.ops.zsweep import fused_z_sweep, zsweep_tables

    bs, nz, A_nz, g, Ng, Dg, ref = _zsweep_var_case(p, ne, qo, mode)
    if layout == "zc":
        bs = [b.transpose(1, 0, 2) for b in bs]
    got = fused_z_sweep(
        None, *(torch.as_tensor(np.ascontiguousarray(x)) for x in bs),
        (g[0],) + tuple(torch.as_tensor(x) for x in g[1:]), zsweep_tables(Ng.T, Dg.T, torch.float64, "cpu"),
        var=(nz, torch.as_tensor(A_nz), 7), layout=layout,
    )
    for x_got, x_ref in zip(got, ref, strict=True):
        assert tuple(x_got.shape) == bs[0].shape
        if layout == "zc":
            x_got = x_got.transpose(0, 1)
        assert _rel(x_got, x_ref) < REL


@pytest.fixture(scope="module")
def var_pair():
    """The p=2 variable-coefficient system in both packages, built once."""
    mesh = _mesh(2)
    return mesh, _build(lt, mesh, _var_diffusion), _build(lp, mesh, _var_diffusion)


def test_var_system_takes_lattice_sf_var_with_reference_planes(var_pair):
    """The constancy proof fails on x*y, so the volume is lattice_sf_var with
    the reference's nonzero (d, i, u) planes, in its order."""
    _, sj, sp = var_pair
    ops = sp._operators()[1]
    assert [d[0] for _, d in ops] == ["lattice_sf_var"] + ["face_banded"] * 4
    (nz, n_eq), A_nz = ops[0][1][1], ops[0][1][3]
    sj.operator_parts()  # builds the reference's operator data
    kind_j, (nz_j, n_eq_j) = sj._contribs[0]._op_data[0], sj._contribs[0]._op_data[1]
    assert kind_j == "lattice_sf_var" and nz == nz_j and n_eq == n_eq_j == 7 and len(nz) == 15
    np.testing.assert_allclose(A_nz.numpy(), np.asarray(sj._contribs[0]._op_data[2]), rtol=0, atol=1e-15)


def test_var_operator_diagonal_rhs_match_reference(var_pair):
    """Apply in both layouts, diagonal and effective rhs at 1e-11; the rhs is
    zero in both (no source: the exact solution stays T = x)."""
    _, sj, sp = var_pair
    assert sp.lattice_layout_key() == sj.lattice_layout_key()
    x = np.random.default_rng(1).normal(size=(sj.n_dofs, 1))
    xt = torch.as_tensor(x)
    y_lat = _jax_apply(sj, sj.to_lattice_layout(x), "lattice")
    fp, cp = sp.operator_parts(layout="lattice")
    assert _rel(fp(sp.to_lattice_layout(xt), *cp), y_lat) < REL
    assert _rel(sp.operator()(xt), sj.from_lattice_layout(y_lat)) < REL
    assert _rel(sp.diagonal(), sj.diagonal()) < REL
    assert float(np.abs(np.asarray(sj.rhs)).max()) == float(sp.rhs.abs().max()) == 0.0
    assert _rel(sp.effective_rhs(), sj.effective_rhs()) < REL


def test_var_cg_jacobi_solve_matches_reference(var_pair):
    """CG + Jacobi: iterations within 1 of the reference, solutions within
    1e-10, and T = x, q = (1, 0, 0) recovered."""
    mesh, sj, sp = var_pair
    opts = dict(tol=1e-12, max_iters=2000)
    rj = sj.solve(lt.CG(lt.IterSolverOpts(**opts), precond=lt.Jacobi()))
    rp = sp.solve(lp.CG(lp.IterSolverOpts(**opts), precond=lp.Jacobi()))
    assert rp.converged and not rp.capped
    assert abs(rp.num_iters - rj.num_iters) <= 1, (rp.num_iters, rj.num_iters)
    xp = sp.x.numpy()
    assert np.abs(xp - np.asarray(sj.x)).max() < 1e-10
    X = xp[:, 0].reshape(-1, 4)
    assert np.abs(X[:, 0] - mesh.node_coords[:, 0]).max() < 1e-10
    assert np.abs(X[:, 1] - 1.0).max() < 1e-10 and np.abs(X[:, 2:]).max() < 1e-10


def test_var_reassembly_scales_operator(var_pair):
    """Reassembly with new coefficient values gives the new operator: A
    scaled by 2 makes the least-squares operator A^T W A 4 times larger."""
    mesh = var_pair[0]

    def scaled(s):
        return lp.wrap_domain_equation_kernel(lambda i, o: _var_diffusion(i, o, s), lp.KernelParams(3, 7, 4))

    problem = lp.ProblemDefinition(4, [0])
    params = lp.AlgebraicSystemParams(eval_strategy=lp.OperatorEvaluationStrategy.MATRIX_FREE)
    s = lp.make_algebraic_system(_port_mesh(mesh), problem, None, params, dtype=torch.float64, device="cpu")
    x = torch.as_tensor(np.random.default_rng(5).normal(size=(s.n_dofs, 1)))
    ys = []
    for scale in (1.0, 2.0):
        s.begin_assembly()
        s.assemble_problem(scaled(scale), [0])
        s.end_assembly()
        assert s._operators()[1][0][1][0] == "lattice_sf_var"
        fn, consts = s.raw_parts()
        ys.append(fn(x, *consts))
    assert _rel(ys[1], 4.0 * ys[0]) < 1e-12
