"""On-card checks of the port's CUDA kernels against their plain torch versions.

These tests need a CUDA device and skip without one: a CUDA kernel has no
CPU mode.  The file imports neither JAX nor the JAX package, so it also runs
where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from l3ster_tpu_torch.ops.lattice_sumfact import banded_tables, local_apply_lattice
from l3ster_tpu_torch.ops.zsweep import (
    detect_diag_geometry,
    fused_z_sweep,
    fused_z_sweep_plain,
    zsweep_tables,
)

# (dtype, tolerance on max abs error / max |f64 plain|): f64 matches to
# rounding; f32 carries ~1e-7 relative rounding through ~100-term sums
TOLS = ((torch.float64, 1e-11), (torch.float32, 2e-5))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _rel(got, ref) -> float:
    return float((got.double() - ref).abs().max() / ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["diag", "full"])
@pytest.mark.parametrize("p,ne,qo,c,n_eq", [(2, 3, 4, 4, 7), (4, 2, 10, 4, 7), (3, 2, 8, 16, 28)])
def test_fused_z_sweep_kernel_matches_plain(cuda, mode, p, ne, qo, c, n_eq):
    """The kernel against its plain version, including ragged column tiles
    and the widest multi-RHS stacking (c = 16, n_eq = 28)."""
    q1 = qo // 2 + 1
    S = R = Q = ne * q1
    n1z, RQ = ne * p + 1, R * Q
    rng = np.random.default_rng(p)
    A = rng.normal(size=(4, n_eq, c)) * (rng.uniform(size=(4, n_eq, c)) > 0.5)
    bs = [rng.normal(size=(c, n1z, RQ)) for _ in range(3)]
    if mode == "diag":
        Jd = np.zeros((3, 3, S, RQ))
        Jd[0, 0] = rng.uniform(0.5, 1.5, (1, RQ))
        Jd[1, 1] = rng.uniform(0.5, 1.5, (1, RQ))
        Jd[2, 2] = rng.uniform(0.5, 1.5, (S, 1))
        wd = rng.uniform(0.5, 1.0, (S, 1)) * rng.uniform(0.5, 1.0, (1, RQ))
        g = detect_diag_geometry(Jd.reshape(3, 3, -1), wd.reshape(-1), S)
    else:
        Ji = rng.normal(size=(9, S, RQ)) * 0.1 + np.eye(3).reshape(9, 1, 1)
        g = ("full", Ji, rng.uniform(0.5, 1.0, (S, RQ)))
    Ng, Dg = banded_tables(p, qo, ne)
    t64 = zsweep_tables(Ng.T, Dg.T, torch.float64, cuda)
    b64 = [torch.as_tensor(x, device=cuda) for x in bs]
    g64 = (g[0],) + tuple(torch.as_tensor(x, device=cuda) for x in g[1:])
    ref = fused_z_sweep_plain(A, *b64, g64, t64.NzT, t64.DzT)
    for dt, tol in TOLS:
        tabs = zsweep_tables(Ng.T, Dg.T, dt, cuda)
        got = fused_z_sweep(A, *(x.to(dt) for x in b64), (g[0],) + tuple(x.to(dt) for x in g64[1:]), tabs)
        torch.cuda.synchronize()
        for x_got, x_ref in zip(got, ref):
            assert _rel(x_got, x_ref) < tol, (dt, mode)


@pytest.mark.cuda
def test_local_apply_lattice_cuda_matches_cpu(cuda):
    """The whole lattice apply on the card (kernel) against the CPU (plain)."""
    order, ne, q_order = 3, (2, 3, 2), 10
    n1 = tuple(order * e + 1 for e in ne)
    rng = np.random.default_rng(7)
    A = rng.normal(size=(4, 7, 4)) * (rng.uniform(size=(4, 7, 4)) > 0.5)
    x = torch.as_tensor(rng.normal(size=(int(np.prod(n1)), 4)))
    q1 = q_order // 2 + 1
    S, R, Q = (q1 * e for e in reversed(ne))
    geom = ("diag",) + tuple(
        torch.as_tensor(rng.uniform(0.5, 1.5, sh))
        for sh in [(1, R * Q), (1, R * Q), (S, 1), (1, R * Q), (S, 1)]
    )
    ref = local_apply_lattice(A, None, None, order, q_order, n1, ne, x, geom=geom)
    got = local_apply_lattice(
        A, None, None, order, q_order, n1, ne, x.to(cuda),
        geom=(geom[0],) + tuple(v.to(cuda) for v in geom[1:]),
    )
    assert _rel(got.cpu(), ref) < 1e-11
