"""The reference's two opt-in lattice pipelines in the port, against the JAX package, f64 on the CPU.

* The x/y stage matmul (``ops/stages.py``, plain version) and its tables
  against ``l3ster_tpu/ops/pallas_stages.py`` (Pallas in interpret mode,
  ``split=False`` tables), and the whole x/y pipeline against the
  reference's ``_apply_xy_pallas`` on a box with unequal axis counts, where
  a (Q, R) lane-order slip would show.
* The v1 z-sweep (``ops/zsweep_v1.py``, plain version) against
  ``l3ster_tpu/ops/pallas_zsweep.py:fused_z_sweep`` in interpret mode.

The port's bench system under each switch is held against its default
pipeline and the reference in ``tests/test_torch_system.py``, which builds
the reference's bench system once.

Tolerances are the reference's own (tests/test_lattice_sf.py): 1e-11 of max
|reference|.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_system import _rel, jax_run
from tests.torch_reference_fixtures import fast_reference_compiles, per_test_limit  # noqa: F401 (fixtures)

REL = 1e-11


def _sparse_A(rng, n_eq=7, c=4):
    return rng.normal(size=(4, n_eq, c)) * (rng.uniform(size=(4, n_eq, c)) > 0.5)


@pytest.mark.parametrize("kind", ["ND", "N", "NDT", "NT"])
def test_stage_tables_match_reference(kind):
    from l3ster_tpu.ops import pallas_stages as js
    from l3ster_tpu_torch.ops import stages as ps

    for order, qo, ne in [(2, 6, 3), (6, 22, 2)]:
        ref = np.asarray(js.stage_tables(order, qo, ne, kind, False))
        np.testing.assert_array_equal(ps.stage_tables(order, qo, ne, kind), ref)
        if kind == "NDT":
            ref = np.asarray(js.kc_transpose_tables(order, qo, ne, False))
            np.testing.assert_array_equal(ps.kc_transpose_tables(order, qo, ne), ref)


@pytest.mark.parametrize("kind", ["ND", "N", "NDT", "NT"])
def test_band_descriptor_covers_table(kind):
    """The band descriptor of each table kind (p = 2, 3; ne = 2, 3) holds
    exactly T's nonzero rows per column and K half, a walk over those bands
    alone gives ``x @ T`` (f64, 1e-14 of max |x @ T|), and its packed values
    rebuild T."""
    from l3ster_tpu_torch.ops import stages as ps

    rng = np.random.default_rng(5)
    for order, ne in [(2, 2), (2, 3), (3, 2), (3, 3)]:
        T = ps.stage_tables(order, 2 * order + 2, ne, kind)
        K, N = T.shape
        k1 = K // 2 if kind == "NDT" else K
        band = ps.band_descriptor(T, k1)
        desc = band.desc.numpy()
        assert desc.shape == (N, 4) and band.k1 == k1
        x = rng.normal(size=(9, K))
        got = np.zeros((9, N))
        for n in range(N):
            for h, lo in enumerate((0, k1)):
                first, count = desc[n, 2 * h : 2 * h + 2]
                rows = np.flatnonzero(T[lo : (k1 if h == 0 else K), n])
                if count == 0:
                    assert rows.size == 0
                    continue
                assert (rows.min(), rows.max()) == (first, first + count - 1)
                r = lo + first + np.arange(count)
                got[:, n] += x[:, r] @ T[r, n]
        a = ps._vec_width(k1, K - k1, 8)  # span: the widest union of 4 columns' bands, in whole vectors
        for h, lo, hi in ((0, 0, k1), (1, k1, K)):
            widths = [0]
            for g in range(0, N, 4):
                rows = np.flatnonzero(T[lo:hi, g : g + 4].any(axis=1))
                if rows.size:
                    widths.append(-(-(rows.max() + 1) // a) * a - rows.min() // a * a)
            assert band.span[h] == max(widths)
        ref = x @ T
        assert np.abs(got - ref).max() <= 1e-14 * np.abs(ref).max()
        # the packed values put T back together from the group unions
        # (unions widened to whole 16-byte vectors where both halves are)
        vals, back = band.values.numpy(), np.zeros_like(T)
        a = ps._vec_width(k1, K - k1, 8)
        for g in range(vals.shape[0]):
            cols = slice(4 * g, min(4 * g + 4, N))
            for h, lo in enumerate((0, k1)):
                f, cnt = desc[cols, 2 * h], desc[cols, 2 * h + 1]
                if cnt.any():
                    kb, end = f[cnt > 0].min() // a * a, -(-(f + cnt).max() // a) * a
                    off = band.span[0] if h else 0
                    back[lo + kb : lo + end, cols] = vals[g, off : off + end - kb, : cols.stop - cols.start]
        np.testing.assert_array_equal(back, T)


def test_stage_launch_shapes_fit():
    """The kernel's launch shapes at the x/y stages of the bench (6^3 hexes)
    and of a 12^3 box, f32 and f64: within the block and shared-memory
    limits, the padded-row path where both K halves are whole 16-byte
    vectors, and one slab (block) per rgs * rm rows."""
    from l3ster_tpu_torch.ops import stages as ps
    from l3ster_tpu_torch.ops._cuda import SMEM_LIMIT

    for ne in (6, 12):
        n1, Qa = 6 * ne + 1, 12 * ne
        for kind, M in (("ND", 4 * n1 * n1), ("N", 4 * n1 * Qa), ("NDT", 4 * n1 * Qa), ("NT", 4 * n1 * Qa)):
            T = ps.stage_tables(6, 22, ne, kind)
            K, N = T.shape
            k1 = K // 2 if kind == "NDT" else K
            for dtype in (torch.float32, torch.float64):
                band = ps.band_descriptor(T, k1, dtype=dtype)
                sh = ps.launch_shape(M, N, k1, K - k1, band.span, band.values.element_size(), 132)
                assert sh["smem"] <= SMEM_LIMIT and sh["threads"] <= 256
                assert sh["vec"] == (kind in ("NDT", "NT"))
                assert sh["slabs"] == -(-M // (sh["rgs"] * sh["rm"]))


def test_stage_band_belongs_to_its_table():
    """A band is held to the table it was built from: a call with that table
    gives ``x @ T``; a call with another table of the same shape, or with a
    copy of its own, raises (the kernel would read the band's values)."""
    from l3ster_tpu_torch.ops import stages as ps

    T = ps.stage_tables(2, 6, 2, "ND")
    band = ps.band_descriptor(T, T.shape[0])
    x = torch.as_tensor(np.random.default_rng(6).normal(size=(5, T.shape[0])))
    got = ps.kstacked_matmul(x, None, band.table, T.shape[1], band)
    assert float((got - x @ torch.as_tensor(T)).abs().max()) <= 1e-14
    table, cached = ps.device_table(2, 6, 2, "ND", torch.float64, torch.device("cpu"))
    assert cached.built_from(table) and table is cached.table
    for other in (torch.as_tensor(T[::-1].copy()), band.table.clone()):
        with pytest.raises(ValueError, match="another table"):
            ps.kstacked_matmul(x, None, other, T.shape[1], band)


@pytest.mark.parametrize("form", ["single", "pair"])
def test_kstacked_matmul_plain_matches_pallas(form):
    """``x @ T`` (an [N|D] interpolation stage) and ``x @ T1 + x2 @ T2`` (a
    K-concat transpose stage) with a ragged row count."""
    import jax.numpy as jnp

    from l3ster_tpu.ops import pallas_stages as js
    from l3ster_tpu_torch.ops import stages as ps

    order, qo, ne, M = 3, 8, 2, 67
    rng = np.random.default_rng(3)
    if form == "single":
        T = ps.stage_tables(order, qo, ne, "ND")
        x, x2 = rng.normal(size=(M, T.shape[0])), None
    else:
        T = ps.stage_tables(order, qo, ne, "NDT")
        x, x2 = rng.normal(size=(M, T.shape[0] // 2)), rng.normal(size=(M, T.shape[0] // 2))
    N = T.shape[1]
    ref = jax_run(
        lambda x, *x2: js.kstacked_matmul(x, x2[0] if x2 else None, jnp.asarray(T), N, interpret=True),
        jnp.asarray(x), *([] if x2 is None else [jnp.asarray(x2)]),
    )
    got = ps.kstacked_matmul(
        torch.as_tensor(x), None if x2 is None else torch.as_tensor(x2), torch.as_tensor(T), N
    )
    assert tuple(got.shape) == (M, N)
    assert _rel(got, ref) < REL


@pytest.mark.parametrize("p,ne,qo", [(2, 3, 4), (4, 2, 10)])
def test_zsweep_v1_plain_matches_pallas(p, ne, qo):
    """The v1 wrapper on (n1z, c, RQ) tensors with full geometry."""
    import jax.numpy as jnp

    from l3ster_tpu.ops.pallas_zsweep import fused_z_sweep as jax_v1
    from l3ster_tpu_torch.ops import zsweep_v1
    from l3ster_tpu_torch.ops.lattice_sumfact import banded_tables

    q1 = qo // 2 + 1
    S = R = Q = ne * q1
    RQ, n1z = R * Q, ne * p + 1
    rng = np.random.default_rng(p)
    A = _sparse_A(rng)
    bs = [rng.normal(size=(n1z, 4, RQ)) for _ in range(3)]
    ji = rng.normal(size=(9, S, RQ)) * 0.1 + np.eye(3).reshape(9, 1, 1)
    w = rng.uniform(0.5, 1.0, (S, RQ))
    Ng, Dg = banded_tables(p, qo, ne)
    args = bs + [ji, w, Ng.T, Dg.T]
    ref = jax_run(
        lambda *a: jax_v1(A, *a, block=256, interpret=True), *(jnp.asarray(x) for x in args)
    )
    got = zsweep_v1.fused_z_sweep(A, *(torch.as_tensor(np.ascontiguousarray(x)) for x in args))
    for x_got, x_ref in zip(got, ref, strict=True):
        assert tuple(x_got.shape) == (n1z, 4, RQ)
        assert _rel(x_got, x_ref) < REL


@pytest.mark.parametrize("mode", ["diag", "full"])
def test_xy_pipeline_matches_reference(mode):
    """``local_apply_lattice(variant="xy")`` against ``_apply_xy_pallas`` on a
    box of 3 x 2 x 2 hexes (R != Q), and against the port's default pipeline."""
    import jax.numpy as jnp

    from l3ster_tpu.ops import pallas_stages as js
    from l3ster_tpu.ops.lattice_sumfact import _apply_xy_pallas
    from l3ster_tpu_torch.ops.lattice_sumfact import local_apply_lattice

    order, q_order, ne = 2, 6, (3, 2, 2)
    q1 = q_order // 2 + 1
    n1 = tuple(order * e + 1 for e in ne)
    S, R, Q = (q1 * e for e in reversed(ne))
    rng = np.random.default_rng(11)
    A = _sparse_A(rng)
    t = rng.normal(size=(4,) + tuple(reversed(n1)))
    if mode == "diag":
        geom = ("diag",) + tuple(
            rng.uniform(0.5, 1.5, sh) for sh in [(1, R * Q), (1, R * Q), (S, 1), (1, R * Q), (S, 1)]
        )
    else:
        ji = rng.normal(size=(9, S, R * Q)) * 0.1 + np.eye(3).reshape(9, 1, 1)
        geom = ("full", ji, rng.uniform(0.5, 1.0, (S, R * Q)))
    for ne_a in ne[:2]:  # fill the reference's table caches outside the trace
        for kind in ("ND", "N", "NT"):
            js.stage_tables(order, q_order, ne_a, kind, False)
        js.kc_transpose_tables(order, q_order, ne_a, False)
    ref = jax_run(
        lambda t, *g: _apply_xy_pallas(A, t, (mode,) + g, order, q_order, ne, (S, R, Q), interpret=True),
        jnp.asarray(t), *(jnp.asarray(x) for x in geom[1:]),
    )
    gt = (mode,) + tuple(torch.as_tensor(x) for x in geom[1:])
    tt = torch.as_tensor(t)
    if mode == "diag":
        kw = dict(geom=gt)
        Ji_l = w_l = None
    else:
        kw = {}
        Ji_l, w_l = gt[1].reshape(3, 3, -1), gt[2].reshape(-1)
    got = local_apply_lattice(A, Ji_l, w_l, order, q_order, n1, ne, tt, tensor_io=True, variant="xy", **kw)
    assert _rel(got, ref) < REL
    v2 = local_apply_lattice(A, Ji_l, w_l, order, q_order, n1, ne, tt, tensor_io=True, **kw)
    assert _rel(got, v2) < REL
