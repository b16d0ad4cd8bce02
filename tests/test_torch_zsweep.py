"""The port's fused z-sweep (plain torch version) against the JAX Pallas kernel.

``l3ster_tpu_torch.ops.zsweep.fused_z_sweep`` on CPU tensors runs its plain
version; the reference is ``fused_z_sweep_v2`` in interpret mode with the
natural ``layout="cz"``, in f64, in diagonal and full geometry modes.  The
tolerance is the reference's own oracle tolerance (test_lattice_sf.py:206).
"""

import numpy as np
import pytest
import torch

from l3ster_tpu.ops.lattice_sumfact import banded_tables as jax_banded_tables
from l3ster_tpu.ops.pallas_zsweep2 import detect_diag_geometry as jax_detect
from l3ster_tpu.ops.pallas_zsweep2 import fused_z_sweep_v2
from l3ster_tpu_torch.ops.lattice_sumfact import banded_tables
from l3ster_tpu_torch.ops.zsweep import detect_diag_geometry, fused_z_sweep, zsweep_layers, zsweep_tables
from tests.test_torch_system import jax_run
from tests.torch_reference_fixtures import fast_reference_compiles, per_test_limit  # noqa: F401 (fixtures)

TOL = 1e-11  # max abs error over max |reference|, f64


def _inputs(p, ne, qo, seed):
    q1 = qo // 2 + 1
    S = R = Q = ne * q1
    EQ = S * R * Q
    n1z = ne * p + 1
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(4, 7, 4)) * (rng.uniform(size=(4, 7, 4)) > 0.5)
    b, bdy, bdx = (rng.normal(size=(4, n1z, R * Q)) for _ in range(3))
    Ji = rng.normal(size=(3, 3, EQ)) * 0.1 + np.eye(3)[:, :, None]
    w = rng.uniform(0.5, 1.0, EQ)
    Jd = np.zeros((3, 3, S, R * Q))
    Jd[0, 0] = rng.uniform(0.5, 1.5, (1, R * Q))
    Jd[1, 1] = rng.uniform(0.5, 1.5, (1, R * Q))
    Jd[2, 2] = rng.uniform(0.5, 1.5, (S, 1))
    wd = rng.uniform(0.5, 1.0, (S, 1)) * rng.uniform(0.5, 1.0, (1, R * Q))
    return A, (b, bdy, bdx), (Ji, w), (Jd.reshape(3, 3, EQ), wd.reshape(EQ)), S, R * Q


@pytest.mark.parametrize("mode", ["diag", "full"])
@pytest.mark.parametrize("p,ne,qo", [(2, 3, 4), (4, 2, 10)])
def test_fused_z_sweep_plain_matches_pallas(p, ne, qo, mode):
    import jax.numpy as jnp

    A, bs, (Ji, w), (Jd, wd), S, RQ = _inputs(p, ne, qo, seed=p)
    Ng, Dg = banded_tables(p, qo, ne)
    np.testing.assert_array_equal(Ng, jax_banded_tables(p, qo, ne)[0])
    if mode == "diag":
        g = detect_diag_geometry(Jd, wd, S)
        assert g is not None and g[0] == "diag"
        gj = jax_detect(Jd, wd, S)
        assert all(np.array_equal(x, y) for x, y in zip(g[1:], gj[1:]))
    else:
        g = ("full", Ji.reshape(9, S, RQ), w.reshape(S, RQ))
    ref = jax_run(
        lambda *x: fused_z_sweep_v2(
            A, *x[:3], (g[0],) + x[3:], jnp.asarray(Ng.T), jnp.asarray(Dg.T), block=256,
            interpret=True, host_tables=(Ng.T, Dg.T), layout="cz",
        ),
        *(jnp.asarray(x) for x in list(bs) + list(g[1:])),
    )
    got = fused_z_sweep(
        A, *(torch.as_tensor(x) for x in bs),
        (g[0],) + tuple(torch.as_tensor(x) for x in g[1:]),
        zsweep_tables(Ng.T, Dg.T, torch.float64, "cpu"),
    )
    for x_ref, x_got in zip(ref, got):
        x_ref = np.asarray(x_ref)
        err = np.abs(x_got.numpy() - x_ref).max() / np.abs(x_ref).max()
        assert err < TOL, err


def test_detect_diag_geometry_matches_reference():
    """Same answer as the reference on axis-aligned and skewed geometry."""
    _, _, (Ji, w), (Jd, wd), S, _ = _inputs(2, 3, 4, seed=3)
    assert detect_diag_geometry(Ji, w, S) is None
    assert jax_detect(Ji, w, S) is None
    g, gj = detect_diag_geometry(Jd, wd, S), jax_detect(Jd, wd, S)
    assert g[0] == gj[0] == "diag"
    assert all(np.array_equal(x, y) for x, y in zip(g[1:], gj[1:]))


def test_zsweep_band_limits():
    """The kernel's layer blocks cover every nonzero of the tables and no more
    than each layer's node rows."""
    Ng, Dg = banded_tables(3, 8, 2)
    tabs = zsweep_tables(Ng.T, Dg.T, torch.float64, "cpu")
    nz = (Ng.T != 0) | (Dg.T != 0)
    covered = np.zeros_like(nz)
    for s0, nq, z0, nn in tabs.layers:
        covered[z0 : z0 + nn, s0 : s0 + nq] = True
        for s in range(s0, s0 + nq):
            rows = np.nonzero(nz[:, s])[0]
            assert (rows.min(), rows.max()) == (z0, z0 + nn - 1)
    assert not (nz & ~covered).any()
    np.testing.assert_array_equal(tabs.lay.numpy(), tabs.layers)


# (p, qo, ne_z): the bench's and 12^3's z shapes, ne_z = 1 and 2, p = 1, QO = 2p, p = 8
LAYER_CASES = [(6, 22, 6), (6, 22, 12), (6, 22, 1), (4, 10, 2), (2, 4, 3), (1, 2, 3), (3, 6, 2), (8, 30, 2)]


@pytest.mark.parametrize("p,qo,ne", LAYER_CASES)
def test_zsweep_layers_rebuild_tables(p, qo, ne):
    """The compact layer blocks rebuild banded_tables' dense (n1z, S) tables
    exactly, and the layers partition the QP rows, neighbours sharing exactly
    the one node row at their boundary."""
    Ng, Dg = banded_tables(p, qo, ne)
    lay, blk = zsweep_layers(Ng.T, Dg.T)
    n1z, S = Ng.T.shape
    assert lay.shape == (ne, 4) and blk.shape == (2, ne, qo // 2 + 1, p + 1)
    rebuilt = np.zeros((2, n1z, S))
    for k, (s0, nq, z0, nn) in enumerate(lay):
        rebuilt[:, z0 : z0 + nn, s0 : s0 + nq] = blk[:, k, :nq, :nn].transpose(0, 2, 1)
    np.testing.assert_array_equal(rebuilt[0], Ng.T)
    np.testing.assert_array_equal(rebuilt[1], Dg.T)
    np.testing.assert_array_equal(np.repeat(np.arange(ne), lay[:, 1]), np.arange(S) // (qo // 2 + 1))
    hits = np.zeros(n1z, int)
    for _, _, z0, nn in lay:
        hits[z0 : z0 + nn] += 1
    shared = np.nonzero(hits == 2)[0]
    np.testing.assert_array_equal(shared, lay[1:, 2])
    assert hits.min() == 1 and hits.max() == (2 if ne > 1 else 1)


def test_zsweep_layers_reject_unstructured_tables():
    """A table the kernel cannot walk layer by layer raises."""
    rng = np.random.default_rng(0)
    dense = rng.normal(size=(10, 12))
    dense[0] = 0
    with pytest.raises(ValueError, match="layer structure"):
        zsweep_layers(dense, dense)  # node row 0 is never used
    Ng, Dg = banded_tables(2, 4, 2)
    split = np.zeros((Ng.shape[1] + 1, Ng.shape[0]))  # the two layers share no node row
    split[:3, :3], split[3:, 3:] = Ng.T[:3, :3], Ng.T[2:, 3:]
    with pytest.raises(ValueError, match="layer structure"):
        zsweep_layers(split, split)
    empty = Ng.T.copy()
    empty[:, 1] = 0
    with pytest.raises(ValueError, match="no nonzero"):
        zsweep_layers(empty, np.zeros_like(empty))


@pytest.mark.parametrize("itemsize", [4, 8])
def test_launch_shapes_fit_shared_memory(itemsize):
    """Both kernels' launch shapes keep one block under SMEM_LIMIT at the bench
    and 12^3 z-shapes (c = 4, constant and variable, and the widest stacking,
    c = 16) and at the
    cylinder's p = 4, and the z-sweep gives the card's 132 SMs at least two
    blocks each."""
    from l3ster_tpu_torch.ops._cuda import SMEM_LIMIT
    from l3ster_tpu_torch.ops.sumfact_fused import launch_shape as sf_shape
    from l3ster_tpu_torch.ops.zsweep import launch_shape

    for ne in (6, 12):
        Ng, Dg = banded_tables(6, 22, ne)
        dims = zsweep_layers(Ng.T, Dg.T)[1].shape[1:]
        RQ = (12 * ne) ** 2
        # the bench kernel: 15 entries, constant or as 15 streamed planes; its 4-rhs stacking
        for c, n_eq, K, n_ent in ((4, 7, 0, 15), (4, 7, 15, 15), (16, 28, 0, 60)):
            sh = launch_shape(c, n_eq, K, n_ent, dims, RQ, itemsize, 132)
            assert sh["smem"] <= SMEM_LIMIT and sh["tq"] * sh["by"] <= 384
            assert sh["chunks"] * sh["CL"] >= ne > (sh["chunks"] - 1) * sh["CL"]
            if c == 4:
                assert sh["tq"] == 32 and -(-RQ // 32) * sh["chunks"] >= 2 * 132
    Ng, Dg = banded_tables(8, 30, 2)  # p = 8: layers of 9 node rows
    sh = launch_shape(4, 7, 15, 15, zsweep_layers(Ng.T, Dg.T)[1].shape[1:], 32 * 32, itemsize, 132)
    assert sh["smem"] <= SMEM_LIMIT
    for dim in (2, 3):
        sh = sf_shape(4, 14, dim, 4, 7, 15, itemsize)
        assert sh["smem"] <= SMEM_LIMIT and sh["threads"] == 256 and sh["staged"] and not sh["generic"]
    # orders without an unrolled kernel take the run-time-sized one: q1 = 2p + 1, 2D at p = 7
    for order, qo, dim in ((3, 12, 3), (4, 16, 3), (7, 26, 2)):
        sh = sf_shape(order, qo, dim, 4, 7, 15, itemsize)
        assert sh["generic"] and sh["groups"] == 0 and sh["smem"] <= SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        sf_shape(7, 26, 3, 4, 7, 15, itemsize)
