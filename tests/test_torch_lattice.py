"""The port's lattice operator pieces against the JAX package, f64 on the CPU.

``local_apply_lattice`` with factorized diagonal geometry runs the
reference's fused Pallas z-sweep in interpret mode; with full geometry the
reference runs its unfused XLA chain.  The port runs the plain z-sweep in
both.  Tolerances follow the reference's oracles (test_lattice_sf.py).
"""

import numpy as np
import pytest
import torch

from l3ster_tpu.ops import lattice_sumfact as jls
from l3ster_tpu_torch.ops import lattice_sumfact as pls
from tests.test_torch_system import jax_run
from tests.torch_reference_fixtures import fast_reference_compiles, per_test_limit  # noqa: F401 (fixtures)

REL = 1e-11  # max abs error over max |reference|


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("mode", ["diag", "full"])
@pytest.mark.parametrize("order,ne", [(2, (2, 3, 2)), (3, (2, 2, 2))])
def test_local_apply_lattice_matches_reference(order, ne, mode):
    import jax.numpy as jnp

    q_order = 2 * (2 * order - 1)
    q1 = q_order // 2 + 1
    n1 = tuple(order * e + 1 for e in ne)
    S, R, Q = (q1 * e for e in reversed(ne))
    EQ = S * R * Q
    rng = np.random.default_rng(order)
    A = rng.normal(size=(4, 7, 4)) * (rng.uniform(size=(4, 7, 4)) > 0.5)
    x = rng.normal(size=(int(np.prod(n1)), 4))
    if mode == "diag":
        geom = (
            "diag",
            rng.uniform(0.5, 1.5, (1, R * Q)), rng.uniform(0.5, 1.5, (1, R * Q)),
            rng.uniform(0.5, 1.5, (S, 1)), rng.uniform(0.5, 1.0, (1, R * Q)),
            rng.uniform(0.5, 1.0, (S, 1)),
        )
        ref = jax_run(
            lambda x, *g: jls.local_apply_lattice(A, None, None, None, order, q_order, n1, ne, x, geom=("diag",) + g),
            jnp.asarray(x), *(jnp.asarray(g) for g in geom[1:]),
        )
        got = pls.local_apply_lattice(
            A, None, None, order, q_order, n1, ne, torch.as_tensor(x),
            geom=("diag",) + tuple(torch.as_tensor(g) for g in geom[1:]),
        )
    else:
        Ji = rng.normal(size=(3, 3, EQ)) * 0.1 + np.eye(3)[:, :, None]
        w = rng.uniform(0.5, 1.0, EQ)
        ref = jax_run(
            lambda Ji, w, x: jls.local_apply_lattice(A, None, Ji, w, order, q_order, n1, ne, x),
            jnp.asarray(Ji), jnp.asarray(w), jnp.asarray(x),
        )
        got = pls.local_apply_lattice(
            A, torch.as_tensor(Ji), torch.as_tensor(w), order, q_order, n1, ne, torch.as_tensor(x)
        )
    assert _rel(got, ref) < REL


def test_face_apply_banded_matches_reference():
    import jax.numpy as jnp

    order, q_order, ne2 = 3, 10, (2, 3)
    q1 = q_order // 2 + 1
    n12 = tuple(order * e + 1 for e in ne2)
    fp = dict(axis=0, hi=False, n1=(n12[0],) + n12, plan2d=(n12, ne2, None, None))
    rng = np.random.default_rng(4)
    E, Q = int(np.prod(ne2)), q1 * q1
    A = rng.normal(size=(E, Q, 1, 1, 4))
    w = rng.uniform(0.5, 1.0, (E, Q))
    A_l, w_l = pls.pack_face_banded(A, w, fp, order, q_order)
    A_j, w_j = jls.pack_face_banded(A, w, fp, order, q_order)
    np.testing.assert_array_equal(A_l, A_j)
    np.testing.assert_array_equal(w_l, w_j)
    plane = rng.normal(size=(4,) + tuple(reversed(n12)))
    ref = jls.face_apply_banded(jnp.asarray(A_j), jnp.asarray(w_j), fp, order, q_order, jnp.asarray(plane))
    got = pls.face_apply_banded(
        torch.as_tensor(A_l), torch.as_tensor(w_l), fp, order, q_order, torch.as_tensor(plane)
    )
    assert _rel(got, ref) < REL


def test_lattice_tables_and_permutation_match_reference():
    for order, q_order, ne in [(2, 6, 3), (6, 22, 2)]:
        for a, b in zip(pls.banded_tables(order, q_order, ne), jls.banded_tables(order, q_order, ne)):
            np.testing.assert_array_equal(a, b)
    inv = np.random.default_rng(0).permutation(12)
    for ne in [(2, 3), (2, 3, 2)]:
        np.testing.assert_array_equal(pls.lattice_qp_perm(ne, 4), jls.lattice_qp_perm(ne, 4))
    np.testing.assert_array_equal(
        pls.lattice_qp_perm((2, 3, 2), 3, inv), jls.lattice_qp_perm((2, 3, 2), 3, inv)
    )
