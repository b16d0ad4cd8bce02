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
from l3ster_tpu_torch.ops.zsweep import detect_diag_geometry, fused_z_sweep, zsweep_tables
from tests.test_torch_system import fast_reference_compiles, jax_run  # noqa: F401 (a fixture)

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
    """The kernel's band limits cover every nonzero of the tables and no more."""
    Ng, Dg = banded_tables(3, 8, 2)
    band = zsweep_tables(Ng.T, Dg.T, torch.float64, "cpu").band.numpy()
    n1z, S = Ng.T.shape
    zlo, zhi, slo, shi = np.split(band, [S, 2 * S, 2 * S + n1z])
    nz = (Ng.T != 0) | (Dg.T != 0)
    for s in range(S):
        rows = np.nonzero(nz[:, s])[0]
        assert (zlo[s], zhi[s]) == (rows.min(), rows.max())
    for z in range(n1z):
        cols = np.nonzero(nz[z])[0]
        assert (slo[z], shi[z]) == (cols.min(), cols.max())
