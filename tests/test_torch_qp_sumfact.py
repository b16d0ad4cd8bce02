"""Plain versions of the per-QP kernel (``ops/qp.py``) and the fused sum-factorized
kernel (``ops/sumfact_fused.py``) against the JAX package, and the
``SUM_FACT_PALLAS`` strategy end to end, on the CPU.

The reference's Pallas kernels run in interpret mode here.  The fused
sum-factorized kernels compute in float32 whatever the input dtype, so they
are held at 1e-4 of max |reference| (the reference's own oracle,
``tests/test_pallas.py``); everything else in f64 at 1e-11.  Inputs are made with numpy from a seed: a
sparse random A (zeros must be skipped, not multiplied), J^-1 near the
identity and positive weights.
"""

import numpy as np
import pytest
import torch

import l3ster_tpu as lt
import l3ster_tpu_torch as lp
from tests.test_torch_system import jax_run
from tests.test_torch_unstructured import CYL, _jax_apply, _rel, build
from tests.torch_reference_fixtures import fast_reference_compiles, per_test_limit  # noqa: F401 (fixtures)

REL = 1e-11
PALLAS_REL = 1e-4  # the fused sum-factorized kernels compute in float32


def _inputs(dim, E, Q, c=4, n_eq=7, seed=0):
    rng = np.random.default_rng(seed)
    d1 = dim + 1
    A = rng.normal(size=(d1, n_eq, c)) * (rng.uniform(size=(d1, n_eq, c)) > 0.5)
    ji = rng.normal(size=(E, Q, dim, dim)) * 0.1 + np.eye(dim)
    w = rng.uniform(0.5, 1.0, (E, Q))
    return rng, A, ji, w


@pytest.mark.parametrize("dim", [2, 3])
def test_qp_plain_matches_pallas_reference(dim):
    """qp_algebra_const_plain on (E, c, d1, Q) against qp_algebra_const_pallas on
    the reference's (d1*c, EQ) lanes, permuted to compare."""
    import jax.numpy as jnp

    from l3ster_tpu.ops.pallas_qp import qp_algebra_const_pallas
    from l3ster_tpu_torch.ops.qp import qp_algebra_const

    E, Q, c = 3, 50, 4
    rng, A, ji, w = _inputs(dim, E, Q, c)
    G = rng.normal(size=(E, c, dim + 1, Q))
    Ji_t = ji.reshape(E * Q, dim, dim).transpose(1, 2, 0)
    g_lanes = G.transpose(2, 1, 0, 3).reshape((dim + 1) * c, E * Q)
    ref = np.asarray(
        jax_run(
            lambda g, j, w: qp_algebra_const_pallas(A, g, j, w, dim, c, interpret=True),
            jnp.asarray(g_lanes), jnp.asarray(Ji_t.reshape(dim * dim, -1)), jnp.asarray(w.reshape(-1)),
        )
    )
    got = qp_algebra_const(A, torch.as_tensor(G), torch.as_tensor(Ji_t.copy()), torch.as_tensor(w.reshape(-1)))
    assert got.shape == G.shape
    assert _rel(got.numpy().transpose(2, 1, 0, 3).reshape(ref.shape), ref) < REL


@pytest.mark.parametrize("dim,order", [(2, 2), (2, 3), (3, 2), (3, 3)])
def test_sumfact_plain_matches_reference(dim, order):
    """sumfact_const_apply_plain against the reference's f64
    local_apply_sumfact_const (1e-11) and its Pallas kernel (1e-4)."""
    import jax.numpy as jnp

    from l3ster_tpu.algsys.local import local_apply_sumfact_const
    from l3ster_tpu.ops.pallas_sumfact import sumfact_const_apply_pallas
    from l3ster_tpu_torch.ops.sumfact_fused import sumfact_const_apply

    E, c = 5, 4
    qo = lp.AssemblyOptions().quadrature_order(order)
    Q = (qo // 2 + 1) ** dim
    rng, A, ji, w = _inputs(dim, E, Q, c, seed=order)
    x = rng.normal(size=(E, (order + 1) ** dim, c))
    got = sumfact_const_apply(A, torch.as_tensor(ji), torch.as_tensor(w), order, qo, dim, torch.as_tensor(x))
    Ji_t = jnp.asarray(ji.reshape(E * Q, dim, dim).transpose(1, 2, 0))
    ref_fn = lambda Ji_t, w, x: local_apply_sumfact_const(A, Ji_t, w, E, order, qo, dim, x)  # noqa: E731
    ref = np.asarray(jax_run(ref_fn, Ji_t, jnp.asarray(w.reshape(-1)), jnp.asarray(x)))
    assert _rel(got, ref) < REL
    pal = np.asarray(
        jax_run(
            lambda ji, w, x: sumfact_const_apply_pallas(A, ji, w, order, qo, dim, x, block_elems=8, interpret=True),
            jnp.asarray(ji), jnp.asarray(w), jnp.asarray(x),
        )
    )
    assert _rel(got, pal) < PALLAS_REL


@pytest.mark.parametrize("dim", [2, 3])
def test_sweeps_and_dense_maps_match_reference(dim):
    """The building blocks: sum-factorized interpolation and transpose sweeps,
    and the dense basis maps, against the reference at 1e-12."""
    import jax.numpy as jnp

    from l3ster_tpu.algsys.local import domain_tables as j_tables
    from l3ster_tpu.ops import dense_eval as jd
    from l3ster_tpu.ops import sumfact as js
    from l3ster_tpu_torch.algsys.local import domain_tables as p_tables
    from l3ster_tpu_torch.ops import dense_eval as pd
    from l3ster_tpu_torch.ops import sumfact as ps

    order, qo, E, c = 3, 10, 4, 3
    et = lp.ElementType.HEX if dim == 3 else lp.ElementType.QUAD
    N1, D1, _ = ps.sumfact_tables_1d(order, qo)
    rng = np.random.default_rng(dim)
    x = rng.normal(size=(E, (order + 1) ** dim, c))
    vj, dj = jax_run(lambda x: js.sumfact_interpolate(x, N1, D1, dim), jnp.asarray(x))
    vp, dp = ps.sumfact_interpolate(torch.as_tensor(x), N1, D1, dim)
    assert _rel(vp, vj) < 1e-12 and _rel(dp, dj) < 1e-12
    Q = vp.shape[1]
    t0 = [rng.normal(size=E * Q) for _ in range(c)]
    td = [[rng.normal(size=E * Q) for _ in range(c)] for _ in range(dim)]
    yj = jax_run(
        lambda a, b: js.sumfact_transpose_channels(a, b, N1, D1, dim, E),
        [jnp.asarray(a) for a in t0], [[jnp.asarray(a) for a in r] for r in td],
    )
    yp = ps.sumfact_transpose_channels([torch.as_tensor(a) for a in t0], [[torch.as_tensor(a) for a in r] for r in td], N1, D1, dim, E)
    assert _rel(yp, yj) < 1e-12
    Bj = jd.dense_basis_matrix(j_tables(lt.ElementType[et.name], order, qo))
    Bp = pd.dense_basis_matrix(p_tables(et, order, qo))
    np.testing.assert_array_equal(Bp, Bj)
    vals_l, rd = jax_run(lambda x, B: jd.dense_interpolate_channels(x, B, dim), jnp.asarray(x), jnp.asarray(Bj))
    G = pd.dense_interpolate_channels(torch.as_tensor(x), torch.as_tensor(Bp), dim)  # (E, c, d1, Q)
    assert _rel(G[:, :, 0].permute(1, 0, 2).reshape(c, -1), np.stack(vals_l)) < 1e-12
    assert _rel(G[:, :, 1:].permute(2, 1, 0, 3).reshape(dim, c, -1), np.stack([np.stack(r) for r in rd])) < 1e-12
    yj = jax_run(lambda a, b, B: jd.dense_transpose_channels(a, b, B, E), vals_l, rd, jnp.asarray(Bj))
    assert _rel(pd.dense_transpose_channels(G, torch.as_tensor(Bp)), yj) < 1e-12


def test_sum_fact_pallas_system_matches_reference():
    """The cylinder system under SUM_FACT_PALLAS: kinds, the float32 apply at
    1e-4 of the reference's f64 sum-factorized operator (the operator its fused
    kernel computes in float32; the kernel itself is held against it in interpret
    mode above), the f64 diagonal and rhs at 1e-11 (the rhs/diagonal pass runs
    in the system dtype, the same under SUM_FACT and SUM_FACT_PALLAS)."""
    mj = lt.generate_mesh(lt.make_cylinder_in_channel_3d(**CYL), order=2)
    mp = lp.generate_mesh(lp.make_cylinder_in_channel_3d(**CYL), order=2)
    sj = build(lt, mj, "SUM_FACT", dirichlet_values=False)
    sp = build(lp, mp, "SUM_FACT_PALLAS", dirichlet_values=False)
    ops = sp._operators()[1]
    assert [d[0] for _, d in ops] == ["pallas"] + ["direct"] * 4
    assert ops[0][1][2].dtype == torch.float32  # J^-1 handed to the kernel in float32
    x = np.random.default_rng(2).normal(size=(sj.n_dofs, 1))
    y = sp.operator()(torch.as_tensor(x))
    assert y.dtype == torch.float64
    assert _rel(y, _jax_apply(sj, x)) < PALLAS_REL
    assert _rel(sp.diagonal(), sj.diagonal()) < REL
    assert _rel(sp.rhs, sj.rhs) < REL


@pytest.mark.parametrize("dim", [2, 3])
def test_coefficient_tables_rebuild_A(dim):
    """The packing every kernel's __constant__ A comes from (``ops/_cuda.py``):
    the by-equation and the by-slot tables each hold A's nonzeros once, and
    nothing else."""
    from l3ster_tpu_torch.ops._cuda import coefficient_tables

    _, A, _, _ = _inputs(dim, 1, 1, c=3, n_eq=5, seed=dim)
    d1, n_eq, c = A.shape
    eqstart, rd, ru, rval, slotstart, teq, tval = coefficient_tables(A)
    nnz = int((A != 0).sum())
    assert len(rval) == len(tval) == nnz and eqstart[-1] == slotstart[-1] == nnz
    by_eq, by_slot = np.zeros_like(A), np.zeros_like(A)
    for i in range(n_eq):
        for e in range(eqstart[i], eqstart[i + 1]):
            by_eq[rd[e], i, ru[e]] = rval[e]
    for s in range(d1 * c):
        for e in range(slotstart[s], slotstart[s + 1]):
            by_slot[s // c, teq[e], s % c] = tval[e]
    np.testing.assert_array_equal(by_eq, A)
    np.testing.assert_array_equal(by_slot, A)


def test_qp_kernel_division_and_launch_shape():
    """The per-QP kernel's host side: the multiply-shift division by Q that
    locates a QP's element (exact for every index below 2^31), and the ring of
    256-QP tiles (the kernel's full tile): RING tiles where they fit in shared
    memory, else two, else one; where one full tile does not fit, the largest
    smaller tile (128, 64, 32 QPs) that does.  Every A within the constant
    tables' limits fits; past them, a raise."""
    from l3ster_tpu_torch.ops._cuda import CA_LIMITS, SMEM_LIMIT
    from l3ster_tpu_torch.ops.qp import RING, fast_div, launch_shape

    rng = np.random.default_rng(0)
    for d in list(range(1, 600)) + [4096, 2**20 + 7, 2**31 - 1]:
        mul, shr = fast_div(d)
        assert 0 <= mul < 2**32
        for n in [0, d - 1, d, 2**31 - 1] + list(rng.integers(0, 2**31, 50)):
            n = int(n)
            assert (n if mul == 0 else (n * mul >> 32) >> shr) == n // d, (d, n)
    sh = launch_shape(3, 4, 7, 15, 4, 256)  # the bench's A in f32
    assert (sh["rows"], sh["nbuf"], sh["tile"]) == (26, RING, 256) and sh["smem"] <= SMEM_LIMIT
    assert launch_shape(3, 8, 15, 240, 8, 256)["nbuf"] == 2 and launch_shape(3, 12, 20, 488, 8, 256)["nbuf"] == 1
    # the widest multi-RHS stacking in f64 (c = 16, n_eq = 28): 256 QPs fit up to
    # 685 nonzeros, 128 QPs beyond
    assert launch_shape(3, 16, 28, 685, 8, 256)["tile"] == 256
    sh = launch_shape(3, 16, 28, 900, 8, 256)
    assert (sh["tile"], sh["nbuf"]) == (128, 2) and sh["smem"] <= SMEM_LIMIT
    assert (launch_shape(3, 16, 28, 2048, 8, 256)["tile"], launch_shape(3, 64, 64, 2048, 8, 256)["tile"]) == (128, 32)
    max_ent, max_eq, max_slot = CA_LIMITS
    for dim in (2, 3):
        for args in ((max_slot // (dim + 1), max_eq, max_ent), (1, 1, 1)):
            assert launch_shape(dim, *args, 8, 256)["smem"] <= SMEM_LIMIT
    for args in ((3, 16, 28, max_ent + 1), (3, 16, max_eq + 1, 900), (3, max_slot // 4 + 1, 28, 900)):
        with pytest.raises(ValueError, match="constant tables"):
            launch_shape(*args, 8, 256)
