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

from tests.test_torch_system import _rel, fast_reference_compiles, jax_run  # noqa: F401 (a fixture)

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
