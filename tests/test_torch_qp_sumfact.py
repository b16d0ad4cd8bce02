"""Plain versions of the per-QP kernel (``ops/qp.py``) and the fused sum-factorized
kernel (``ops/sumfact_fused.py``) against the JAX package, and the
``SUM_FACT_PALLAS`` strategy end to end, on the CPU.

The reference's Pallas kernels run in interpret mode here.  Its fused
sum-factorized kernel computes in float32 whatever the input dtype, so it is
held at 1e-4 of max |reference| (its own oracle, ``tests/test_pallas.py``);
everything else in f64 at 1e-11.  Inputs are made with numpy from a seed: a
sparse random A (zeros must be skipped, not multiplied), J^-1 near the
identity and positive weights.
"""

import numpy as np
import pytest
import torch

import l3ster_tpu as lt
import l3ster_tpu_torch as lp
from tests.test_torch_unstructured import CYL, _jax_apply, _rel, build

REL = 1e-11
PALLAS_REL = 1e-4  # the reference's fused kernel computes in float32


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
        qp_algebra_const_pallas(
            A, jnp.asarray(g_lanes), jnp.asarray(Ji_t.reshape(dim * dim, -1)), jnp.asarray(w.reshape(-1)),
            dim, c, interpret=True,
        )
    )
    got = qp_algebra_const(A, torch.as_tensor(G), torch.as_tensor(Ji_t.copy()), torch.as_tensor(w.reshape(-1)))
    assert got.shape == G.shape
    assert _rel(got.numpy().transpose(2, 1, 0, 3).reshape(ref.shape), ref) < REL


@pytest.mark.parametrize("dim,order", [(2, 2), (2, 3), (3, 2), (3, 3)])
def test_sumfact_plain_matches_reference(dim, order):
    """sumfact_const_apply_plain against the reference's f64
    local_apply_sumfact_const (1e-11) and its Pallas kernel (1e-4)."""
    import jax
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
    ref_fn = jax.jit(lambda Ji_t, w, x: local_apply_sumfact_const(A, Ji_t, w, E, order, qo, dim, x))
    ref = np.asarray(ref_fn(Ji_t, jnp.asarray(w.reshape(-1)), jnp.asarray(x)))
    assert _rel(got, ref) < REL
    pal = np.asarray(
        sumfact_const_apply_pallas(
            A, jnp.asarray(ji), jnp.asarray(w), order, qo, dim, jnp.asarray(x), block_elems=8, interpret=True,
        )
    )
    assert _rel(got, pal) < PALLAS_REL


@pytest.mark.parametrize("dim", [2, 3])
def test_sweeps_and_dense_maps_match_reference(dim):
    """The building blocks: sum-factorized interpolation and transpose sweeps,
    and the dense basis maps, against the reference at 1e-12."""
    import jax
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
    vj, dj = jax.jit(lambda x: js.sumfact_interpolate(x, N1, D1, dim))(jnp.asarray(x))
    vp, dp = ps.sumfact_interpolate(torch.as_tensor(x), N1, D1, dim)
    assert _rel(vp, vj) < 1e-12 and _rel(dp, dj) < 1e-12
    Q = vp.shape[1]
    t0 = [rng.normal(size=E * Q) for _ in range(c)]
    td = [[rng.normal(size=E * Q) for _ in range(c)] for _ in range(dim)]
    yj = jax.jit(lambda a, b: js.sumfact_transpose_channels(a, b, N1, D1, dim, E))(
        [jnp.asarray(a) for a in t0], [[jnp.asarray(a) for a in r] for r in td]
    )
    yp = ps.sumfact_transpose_channels([torch.as_tensor(a) for a in t0], [[torch.as_tensor(a) for a in r] for r in td], N1, D1, dim, E)
    assert _rel(yp, yj) < 1e-12
    Bj = jd.dense_basis_matrix(j_tables(lt.ElementType[et.name], order, qo))
    Bp = pd.dense_basis_matrix(p_tables(et, order, qo))
    np.testing.assert_array_equal(Bp, Bj)
    vals_l, rd = jax.jit(lambda x, B: jd.dense_interpolate_channels(x, B, dim))(jnp.asarray(x), jnp.asarray(Bj))
    G = pd.dense_interpolate_channels(torch.as_tensor(x), torch.as_tensor(Bp), dim)  # (E, c, d1, Q)
    assert _rel(G[:, :, 0].permute(1, 0, 2).reshape(c, -1), np.stack(vals_l)) < 1e-12
    assert _rel(G[:, :, 1:].permute(2, 1, 0, 3).reshape(dim, c, -1), np.stack([np.stack(r) for r in rd])) < 1e-12
    yj = jax.jit(lambda a, b, B: jd.dense_transpose_channels(a, b, B, E))(vals_l, rd, jnp.asarray(Bj))
    assert _rel(pd.dense_transpose_channels(G, torch.as_tensor(Bp)), yj) < 1e-12


def test_sum_fact_pallas_system_matches_reference():
    """The cylinder system under SUM_FACT_PALLAS: kinds, the float32 apply at
    1e-4 (both packages compute it in float32), the f64 diagonal and rhs at
    1e-11 (the rhs/diagonal pass runs in the system dtype)."""
    mj = lt.generate_mesh(lt.make_cylinder_in_channel_3d(**CYL), order=2)
    mp = lp.generate_mesh(lp.make_cylinder_in_channel_3d(**CYL), order=2)
    sj, sp = build(lt, mj, "SUM_FACT_PALLAS"), build(lp, mp, "SUM_FACT_PALLAS")
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
