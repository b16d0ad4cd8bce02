"""On-card checks of the port's CUDA kernels against their plain torch versions.

These tests need a CUDA device and skip without one: a CUDA kernel has no
CPU mode.  The file imports neither JAX nor the JAX package, so it also runs
where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import l3ster_tpu_torch as lp
from l3ster_tpu_torch.ops.lattice_sumfact import banded_tables, local_apply_lattice
from l3ster_tpu_torch.ops.qp import qp_algebra_const, qp_algebra_const_plain
from l3ster_tpu_torch.ops.sumfact_fused import sumfact_const_apply, sumfact_const_apply_plain
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


def _sparse_A(rng, d1, n_eq, c):
    return rng.normal(size=(d1, n_eq, c)) * (rng.uniform(size=(d1, n_eq, c)) > 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [2, 3])
def test_qp_kernel_matches_plain(cuda, dim):
    """The per-QP kernel against its plain version (f64 on the CPU), with a
    ragged last block and a sparse A."""
    E, Q, c, n_eq = 37, 64, 4, 7
    rng = np.random.default_rng(dim)
    A = _sparse_A(rng, dim + 1, n_eq, c)
    G = torch.as_tensor(rng.normal(size=(E, c, dim + 1, Q)))
    Ji_t = torch.as_tensor(rng.normal(size=(dim, dim, E * Q)) * 0.1 + np.eye(dim)[:, :, None])
    w = torch.as_tensor(rng.uniform(0.5, 1.0, E * Q))
    ref = qp_algebra_const_plain(A, G, Ji_t, w)
    for dt, tol in TOLS:
        got = qp_algebra_const(A, *(x.to(cuda, dt) for x in (G, Ji_t, w)))
        torch.cuda.synchronize()
        assert _rel(got.cpu(), ref) < tol, dt


@pytest.mark.cuda
@pytest.mark.parametrize("dim,order", [(2, 2), (2, 3), (3, 2), (3, 3), (3, 4)])
def test_sumfact_kernel_matches_plain(cuda, dim, order):
    """The fused sum-factorized kernel against its plain version (f64 on the CPU)."""
    E, c, n_eq = 9, 4, 7
    qo = lp.AssemblyOptions().quadrature_order(order)
    Q = (qo // 2 + 1) ** dim
    rng = np.random.default_rng(10 * dim + order)
    A = _sparse_A(rng, dim + 1, n_eq, c)
    ji = torch.as_tensor(rng.normal(size=(E, Q, dim, dim)) * 0.1 + np.eye(dim))
    w = torch.as_tensor(rng.uniform(0.5, 1.0, (E, Q)))
    x = torch.as_tensor(rng.normal(size=(E, (order + 1) ** dim, c)))
    ref = sumfact_const_apply_plain(A, ji, w, order, qo, dim, x)
    for dt, tol in TOLS:
        got = sumfact_const_apply(A, ji.to(cuda, dt), w.to(cuda, dt), order, qo, dim, x.to(cuda, dt))
        torch.cuda.synchronize()
        assert _rel(got.cpu(), ref) < tol, dt


def _diffusion_3d(inp, out):
    """3D diffusion, 4 unknowns (T, q), 7 equations, constant coefficients."""
    ops, _ = out
    A0, Ax, Ay, Az = ops
    Ax[0, 1] = Ay[0, 2] = Az[0, 3] = -1.0
    A0[1, 1] = A0[2, 2] = A0[3, 3] = -1.0
    Ax[1, 0] = Ay[2, 0] = Az[3, 0] = 1.0
    Ay[4, 3], Az[4, 2] = 1.0, -1.0
    Ax[5, 3], Az[5, 1] = -1.0, 1.0
    Ax[6, 2], Ay[6, 1] = 1.0, -1.0


def _adiabatic_3d(inp, out):
    ops, _ = out
    for k in range(3):
        ops[0][0, 1 + k] = inp.normal[k]


def _cylinder_system(strategy, device):
    mesh = lp.generate_mesh(
        lp.make_cylinder_in_channel_3d(
            distz=np.linspace(-1, 1, 3), left_offset=4.0, right_offset=6.0, bottom_offset=3.0,
            top_offset=3.0, n_circumf=16, n_radial=4, n_left=3, n_right=6, n_bottom=2, n_top=2,
        ),
        order=2,
    )
    problem = lp.ProblemDefinition(4, [0])
    bcs = lp.BCDefinition(problem)
    bcs.define_dirichlet([3, 4, 5], [0])
    params = lp.AlgebraicSystemParams(eval_strategy=lp.OperatorEvaluationStrategy.MATRIX_FREE)
    system = lp.make_algebraic_system(mesh, problem, bcs, params, dtype=torch.float64, device=device)
    kdir = lp.wrap_boundary_residual_kernel(lambda i, o: o.__setitem__(0, i.point.x), lp.KernelParams(3, 1))
    system.set_dirichlet_bc_values(kdir, [3, 4, 5], [0])
    system.begin_assembly()
    system.assemble_problem(
        lp.wrap_domain_equation_kernel(_diffusion_3d, lp.KernelParams(3, 7, 4)), [0],
        options=lp.AssemblyOptions(eval_strategy=getattr(lp.LocalEvalStrategy, strategy)),
    )
    system.assemble_problem(lp.wrap_boundary_equation_kernel(_adiabatic_3d, lp.KernelParams(3, 1, 4)), [1, 2, 6, 7])
    system.end_assembly()
    return system


@pytest.mark.cuda
@pytest.mark.parametrize("strategy,tol", [("AUTO", 1e-11), ("SUM_FACT_PALLAS", 2e-5)])
def test_cylinder_system_cuda_matches_cpu(cuda, strategy, tol):
    """The cylinder system (dense_const or pallas + direct boundaries) on the
    card against the CPU path.  AUTO runs in f64 on both (index_add_ atomics
    reorder the sums: 1e-11); SUM_FACT_PALLAS computes the volume apply in
    float32 on both, where kernel and plain version round differently."""
    from l3ster_tpu_torch.ops import qp, sumfact_fused

    gpu, cpu = _cylinder_system(strategy, cuda), _cylinder_system(strategy, "cpu")
    assert [d[0] for _, d in gpu._operators()[1]][0] == ("dense_const" if strategy == "AUTO" else "pallas")
    x = torch.as_tensor(np.random.default_rng(5).normal(size=(cpu.n_dofs, 1)))
    before = (qp.launch_count, sumfact_fused.launch_count)
    y = gpu.operator()(x.to(cuda)).cpu()
    assert (qp.launch_count, sumfact_fused.launch_count) != before
    assert _rel(y, cpu.operator()(x)) < tol
    assert _rel(gpu.diagonal().cpu(), cpu.diagonal()) < 1e-11
    assert _rel(gpu.dirichlet_values.cpu(), cpu.dirichlet_values) < 1e-14
