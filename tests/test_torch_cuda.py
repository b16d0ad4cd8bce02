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


def _check_sumfact(cuda, dim, order, qo, E, c, n_eq, seed):
    """The fused kernel against its plain version (f64 on the CPU), in each
    dtype whose element fits one block (p = 6 in 3D fits only in f32)."""
    from l3ster_tpu_torch.ops.sumfact_fused import launch_shape

    Q = (qo // 2 + 1) ** dim
    rng = np.random.default_rng(seed)
    A = _sparse_A(rng, dim + 1, n_eq, c)
    ji = torch.as_tensor(rng.normal(size=(E, Q, dim, dim)) * 0.1 + np.eye(dim))
    w = torch.as_tensor(rng.uniform(0.5, 1.0, (E, Q)))
    x = torch.as_tensor(rng.normal(size=(E, (order + 1) ** dim, c)))
    ref = sumfact_const_apply_plain(A, ji, w, order, qo, dim, x)
    ran = 0
    for dt, tol in TOLS:
        try:
            launch_shape(order, qo, dim, c, n_eq, int((A != 0).sum()), torch.empty((), dtype=dt).element_size())
        except ValueError:
            continue
        got = sumfact_const_apply(A, ji.to(cuda, dt), w.to(cuda, dt), order, qo, dim, x.to(cuda, dt))
        torch.cuda.synchronize()
        assert _rel(got.cpu(), ref) < tol, dt
        ran += 1
    assert ran >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dim,order", [(2, 2), (2, 3), (3, 2), (3, 3), (3, 4), (3, 5), (3, 6)])
def test_sumfact_kernel_matches_plain(cuda, dim, order):
    """The fused sum-factorized kernel against its plain version (f64 on the CPU)."""
    _check_sumfact(cuda, dim, order, lp.AssemblyOptions().quadrature_order(order), 9, 4, 7, 10 * dim + order)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dim,order,qo,E,c,n_eq",
    [(3, 4, 8, 37, 4, 7), (2, 5, 10, 37, 3, 4), (3, 2, 6, 5, 16, 28), (2, 1, 2, 3, 1, 2), (3, 6, 12, 7, 4, 7)],
)
def test_sumfact_kernel_orders_and_channels(cuda, dim, order, qo, E, c, n_eq):
    """The quadrature order 2p (q1 = p + 1), odd element counts, several
    channels per group (c = 16) and one channel (c = 1)."""
    _check_sumfact(cuda, dim, order, qo, E, c, n_eq, 100 + order)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dim,order,value_order,derivative_order",
    [(3, 2, 2, 1), (3, 4, 2, 0), (2, 4, 2, 0), (3, 2, 1, 2), (2, 7, 1, 1), (2, 3, 2, 2)],
)
def test_sumfact_kernel_run_time_sized_orders(cuda, dim, order, value_order, derivative_order):
    """Orders without an unrolled kernel run the run-time-sized one:
    AssemblyOptions' value_order = 2 (q1 = 3p, and 2p + 1 with
    derivative_order = 0) and derivative_order = 2 (q1 = 3p - 1), and 2D at
    p = 7."""
    from l3ster_tpu_torch.ops.sumfact_fused import launch_shape

    qo = lp.AssemblyOptions(value_order=value_order, derivative_order=derivative_order).quadrature_order(order)
    assert launch_shape(order, qo, dim, 4, 7, 15, 4)["generic"]
    _check_sumfact(cuda, dim, order, qo, 11, 4, 7, 200 + order)


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


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["cz", "zc"])
@pytest.mark.parametrize("mode", ["diag", "full"])
@pytest.mark.parametrize("p,ne,qo", [(2, 3, 4), (4, 2, 10)])
def test_fused_z_sweep_var_kernel_matches_plain(cuda, p, ne, qo, mode, layout):
    """The variable-coefficient mode (streamed nonzero planes) and both
    layouts against the plain version (f64 on the card)."""
    q1 = qo // 2 + 1
    S = R = Q = ne * q1
    n1z, RQ, c = ne * p + 1, R * Q, 4
    rng = np.random.default_rng(p + 7)
    mask = rng.uniform(size=(4, 7, c)) > 0.6
    nz = tuple(tuple(int(v) for v in ix) for ix in np.argwhere(mask))
    shape = (c, n1z, RQ) if layout == "cz" else (n1z, c, RQ)
    b64 = [torch.as_tensor(rng.normal(size=shape), device=cuda) for _ in range(3)]
    A_nz = torch.as_tensor(rng.normal(size=(len(nz), S, RQ)), device=cuda)
    if mode == "diag":
        g = ("diag",) + tuple(
            torch.as_tensor(rng.uniform(0.5, 1.5, sh), device=cuda)
            for sh in [(1, RQ), (1, RQ), (S, 1), (1, RQ), (S, 1)]
        )
    else:
        Ji = rng.normal(size=(9, S, RQ)) * 0.1 + np.eye(3).reshape(9, 1, 1)
        g = ("full", torch.as_tensor(Ji, device=cuda), torch.as_tensor(rng.uniform(0.5, 1.0, (S, RQ)), device=cuda))
    Ng, Dg = banded_tables(p, qo, ne)
    t64 = zsweep_tables(Ng.T, Dg.T, torch.float64, cuda)
    ref = fused_z_sweep_plain(None, *b64, g, t64.NzT, t64.DzT, var=(nz, A_nz, 7), layout=layout)
    for dt, tol in TOLS:
        got = fused_z_sweep(
            None, *(x.to(dt) for x in b64), (g[0],) + tuple(x.to(dt) for x in g[1:]),
            zsweep_tables(Ng.T, Dg.T, dt, cuda), var=(nz, A_nz.to(dt), 7), layout=layout,
        )
        torch.cuda.synchronize()
        for x_got, x_ref in zip(got, ref):
            assert tuple(x_got.shape) == shape
            assert _rel(x_got, x_ref) < tol, (dt, mode, layout)


@pytest.mark.cuda
def test_zsweep_v1_kernel_matches_plain(cuda):
    """The v1 wrapper (const A, full geometry, (n1z, c, RQ)) counts its own launches."""
    from l3ster_tpu_torch.ops import zsweep, zsweep_v1

    p, ne, qo = 3, 2, 8
    q1 = qo // 2 + 1
    S = R = Q = ne * q1
    n1z, RQ = ne * p + 1, R * Q
    rng = np.random.default_rng(21)
    A = _sparse_A(rng, 4, 7, 4)
    Ng, Dg = banded_tables(p, qo, ne)
    host = [rng.normal(size=(n1z, 4, RQ)) for _ in range(3)]
    host += [rng.normal(size=(9, S, RQ)) * 0.1 + np.eye(3).reshape(9, 1, 1), rng.uniform(0.5, 1.0, (S, RQ))]
    host += [np.ascontiguousarray(Ng.T), np.ascontiguousarray(Dg.T)]
    ref = zsweep_v1.fused_z_sweep_plain(A, *(torch.as_tensor(x, device=cuda) for x in host))
    for dt, tol in TOLS:
        before = (zsweep_v1.launch_count, zsweep.launch_count)
        got = zsweep_v1.fused_z_sweep(A, *(torch.as_tensor(x, dtype=dt, device=cuda) for x in host))
        torch.cuda.synchronize()
        assert (zsweep_v1.launch_count, zsweep.launch_count) == (before[0] + 1, before[1])
        for x_got, x_ref in zip(got, ref):
            assert _rel(x_got, x_ref) < tol, dt


def _stage_case(case: str, rng):
    """(x, x2, T, pass the band) of one stage-kernel case, in f64 on the host."""
    from l3ster_tpu_torch.ops.stages import stage_tables

    M, pair, T = 1000, False, None
    if case in ("ND", "N", "NT"):
        T = stage_tables(6, 22, 3, case)
    elif case == "NDT":
        T, pair = stage_tables(6, 22, 3, case), True
    elif case == "pair-K1-ne-K2":  # a banded pair table split at K1 = 20 of 33 rows
        T = np.zeros((33, 29))
        for n in range(29):
            T[n % 18 : n % 18 + 3, n] = rng.normal(size=3)
            T[20 + n % 9 : 25 + n % 9, n] = rng.normal(size=5)
        return rng.normal(size=(777, 20)), rng.normal(size=(777, 13)), T, True
    elif case in ("ragged-M", "M-below-slab", "odd-M-K1"):
        T = stage_tables(3, 8, 2, "NDT" if case == "odd-M-K1" else "ND")
        M = {"ragged-M": 1013, "M-below-slab": 3, "odd-M-K1": 333}[case]
        pair = case == "odd-M-K1"
    elif case == "dense":
        T = rng.normal(size=(45, 38))
    elif case == "zero-col-edge-bands":  # column 2 all zero, bands at row 0 and row K - 1
        T = np.zeros((30, 11))
        T[0, 0], T[29, 1], T[0:30, 3] = 1.5, -2.0, rng.normal(size=30)
        T[[0, 29], 4] = 3.0
        T[7:12, 5:] = rng.normal(size=(5, 6))
    elif case in ("offset-view", "no-descriptor"):
        T = stage_tables(6, 22, 3, "NDT")
        pair = True
    elif case == "many-slabs":  # more slabs than the card holds blocks at once
        T, M = stage_tables(6, 22, 3, "ND"), 100_000
    elif case == "many-slabs-padded-rows":
        T, M, pair = stage_tables(6, 22, 3, "NDT"), 60_000, True
    K1 = T.shape[0] // 2 if pair else T.shape[0]
    x = rng.normal(size=(M, K1))
    x2 = rng.normal(size=(M, T.shape[0] - K1)) if pair else None
    return x, x2, T, case != "no-descriptor"


def _at_offset(t: torch.Tensor) -> torch.Tensor:
    buf = t.new_zeros(t.numel() + 1)
    buf[1:] = t.reshape(-1)
    return buf[1:].view(t.shape)


STAGE_CASES = [
    "ND", "N", "NDT", "NT", "pair-K1-ne-K2", "ragged-M", "M-below-slab", "odd-M-K1", "dense",
    "zero-col-edge-bands", "offset-view", "no-descriptor", "many-slabs", "many-slabs-padded-rows",
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", STAGE_CASES)
def test_stage_kernel_matches_plain(cuda, case):
    """The banded stage kernel against its plain version in f64 and f32: the
    four table kinds, a pair split at K1 != K2, slabs that are ragged, wider
    than M or unaligned to 16 bytes (M * K1 not a multiple of 4, x a view at
    an offset), a
    dense table (its band is all of K), a zero column with bands at rows 0 and
    K - 1, a call without a band (built from T), and more slabs than the
    card holds blocks at once, with unpadded and padded rows."""
    from l3ster_tpu_torch.ops.stages import band_descriptor, kstacked_matmul, kstacked_matmul_plain

    rng = np.random.default_rng(8)
    x, x2, T, with_band = _stage_case(case, rng)
    N, K1 = T.shape[1], x.shape[1]
    bands = {dt: band_descriptor(T, K1, cuda, dt) if with_band else None for dt, _ in TOLS}
    if case == "dense":
        assert (bands[torch.float64].desc[:, 1] == T.shape[0]).all()
    xt = torch.as_tensor(x, device=cuda)
    x2t = None if x2 is None else torch.as_tensor(x2, device=cuda)
    Tt = torch.as_tensor(T, device=cuda)
    ref = kstacked_matmul_plain(xt, x2t, Tt, N)
    for dt, tol in TOLS:
        xd, x2d = xt.to(dt), None if x2t is None else x2t.to(dt)
        if case == "offset-view":  # contiguous, but one value past a 16-byte boundary
            xd, x2d = _at_offset(xd), _at_offset(x2d)
            assert xd.is_contiguous() and xd.data_ptr() % 16 != 0
        got = kstacked_matmul(xd, x2d, bands[dt].table if with_band else Tt.to(dt), N, bands[dt])
        torch.cuda.synchronize()
        assert tuple(got.shape) == (x.shape[0], N)
        assert _rel(got, ref) < tol, dt


@pytest.mark.cuda
def test_stage_kernel_counts_launches(cuda):
    """launch_count rises by one per call on the card, with or without a
    band, and not for a call on CPU tensors."""
    from l3ster_tpu_torch.ops import stages

    T = stages.stage_tables(3, 8, 2, "ND")
    x = torch.as_tensor(np.random.default_rng(9).normal(size=(50, T.shape[0])))
    Tt = torch.as_tensor(T)
    band = stages.band_descriptor(T, T.shape[0], cuda, torch.float64)
    before = stages.launch_count
    stages.kstacked_matmul(x, None, Tt, T.shape[1])
    assert stages.launch_count == before
    stages.kstacked_matmul(x.to(cuda), None, band.table, T.shape[1], band)
    assert stages.launch_count == before + 1
    stages.kstacked_matmul(x.to(cuda), None, Tt.to(cuda), T.shape[1])
    torch.cuda.synchronize()
    assert stages.launch_count == before + 2


def _var_diffusion(inp, out):
    """The bench kernel with k(x, y) = 1 + x*y on its conservation row 0."""
    _diffusion_3d(inp, out)
    ops, _ = out
    k = 1.0 + inp.point.x * inp.point.y
    ops[1][0, 1] = ops[2][0, 2] = ops[3][0, 3] = -k


def _box_system(kernel, device, order=3):
    mesh = lp.generate_mesh(lp.make_cube_mesh(np.linspace(0.0, 1.0, 3)), order=order)
    problem = lp.ProblemDefinition(4, [0])
    bcs = lp.BCDefinition(problem)
    bcs.define_dirichlet([5, 6], [0])
    params = lp.AlgebraicSystemParams(eval_strategy=lp.OperatorEvaluationStrategy.MATRIX_FREE)
    system = lp.make_algebraic_system(mesh, problem, bcs, params, dtype=torch.float64, device=device)
    kdir = lp.wrap_boundary_residual_kernel(lambda i, o: o.__setitem__(0, i.point.x), lp.KernelParams(3, 1))
    system.set_dirichlet_bc_values(kdir, [5, 6], [0])
    system.begin_assembly()
    system.assemble_problem(lp.wrap_domain_equation_kernel(kernel, lp.KernelParams(3, 7, 4)), [0])
    system.assemble_problem(lp.wrap_boundary_equation_kernel(_adiabatic_3d, lp.KernelParams(3, 1, 4)), [1, 2, 3, 4])
    system.end_assembly()
    return system


@pytest.mark.cuda
@pytest.mark.parametrize("env", [None, "L3STER_TPU_ZSWEEP=v1", "L3STER_TPU_XY_PALLAS=1"])
def test_box_systems_cuda_match_cpu(cuda, monkeypatch, env):
    """The variable-coefficient box system (lattice_sf_var), and the constant
    one under each opt-in pipeline, on the card against the CPU path, f64."""
    from l3ster_tpu_torch.ops import stages, zsweep, zsweep_v1

    kernel = _var_diffusion if env is None else _diffusion_3d
    if env is not None:
        monkeypatch.setenv(*env.split("="))
    gpu, cpu = _box_system(kernel, cuda), _box_system(kernel, "cpu")
    x = torch.as_tensor(np.random.default_rng(9).normal(size=(cpu.n_dofs, 1)))
    before = (zsweep.launch_count, zsweep_v1.launch_count, stages.launch_count)
    y = gpu.operator()(x.to(cuda)).cpu()
    after = (zsweep.launch_count, zsweep_v1.launch_count, stages.launch_count)
    kind = gpu._operators()[1][0][1][0]
    if env is None:
        assert kind == "lattice_sf_var" and after[0] > before[0]
    elif "ZSWEEP" in env:
        assert kind == "lattice_sf_const" and after[1] > before[1] and after[0] == before[0]
    else:
        assert after[2] > before[2] and after[0] > before[0]
    assert _rel(y, cpu.operator()(x)) < 1e-11
    assert _rel(gpu.effective_rhs().cpu(), cpu.effective_rhs()) < 1e-11


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["cz", "zc"])
@pytest.mark.parametrize("mode", ["const-diag", "var-full", "var-diag"])
@pytest.mark.parametrize(
    "p,qo,ne,RQ",
    [(6, 22, 12, 100), (6, 22, 12, 4100), (6, 22, 1, 300), (3, 8, 1, 77), (2, 4, 2, 50), (8, 30, 3, 90), (9, 18, 2, 40)],
)
def test_fused_z_sweep_layer_shapes_match_plain(cuda, p, qo, ne, RQ, mode, layout):
    """The z-sweep at the 12^3 z-shape (n1z = 73, S = 144) on column counts
    that are not a multiple of the tile, split along z into one-layer chunks
    (RQ = 100: every shared node row added atomically) and three-layer chunks
    (RQ = 4100: rows carried inside a chunk), with one layer (no shared row)
    and two, and at p = 8 and 9 (layers of more node rows than the kernel
    holds in registers at once); f64 and f32 against the plain version in f64."""
    from l3ster_tpu_torch.ops.zsweep import launch_shape, zsweep_layers

    S, n1z, c = ne * (qo // 2 + 1), ne * p + 1, 4
    rng = np.random.default_rng(RQ + ne)
    shape = (c, n1z, RQ) if layout == "cz" else (n1z, c, RQ)
    b64 = [torch.as_tensor(rng.normal(size=shape), device=cuda) for _ in range(3)]
    if mode.startswith("var"):
        A = None
        nz = tuple(tuple(int(v) for v in ix) for ix in np.argwhere(rng.uniform(size=(4, 7, c)) > 0.6))
        var64 = (nz, torch.as_tensor(rng.normal(size=(len(nz), S, RQ)), device=cuda), 7)
    else:
        A, var64 = _sparse_A(rng, 4, 7, c), None
    if mode.endswith("diag"):
        g = ("diag",) + tuple(
            torch.as_tensor(rng.uniform(0.5, 1.5, sh), device=cuda) for sh in [(1, RQ), (1, RQ), (S, 1), (1, RQ), (S, 1)]
        )
    else:
        Ji = rng.normal(size=(9, S, RQ)) * 0.1 + np.eye(3).reshape(9, 1, 1)
        g = ("full", torch.as_tensor(Ji, device=cuda), torch.as_tensor(rng.uniform(0.5, 1.0, (S, RQ)), device=cuda))
    Ng, Dg = banded_tables(p, qo, ne)
    K = 0 if var64 is None else len(var64[0])
    n_ent = K if var64 is not None else int((A != 0).sum())
    dims = zsweep_layers(Ng.T, Dg.T)[1].shape[1:]
    sh = launch_shape(c, 7, K, n_ent, dims, RQ, 8, torch.cuda.get_device_properties(cuda).multi_processor_count)
    if (p, ne, RQ) == (6, 12, 4100):
        assert 1 < sh["CL"] < ne  # both the carried and the atomic shared rows
    t64 = zsweep_tables(Ng.T, Dg.T, torch.float64, cuda)
    ref = fused_z_sweep_plain(A, *b64, g, t64.NzT, t64.DzT, var=var64, layout=layout)
    for dt, tol in TOLS:
        var = None if var64 is None else (var64[0], var64[1].to(dt), 7)
        got = fused_z_sweep(
            A, *(x.to(dt) for x in b64), (g[0],) + tuple(x.to(dt) for x in g[1:]),
            zsweep_tables(Ng.T, Dg.T, dt, cuda), var=var, layout=layout,
        )
        torch.cuda.synchronize()
        for x_got, x_ref in zip(got, ref):
            assert tuple(x_got.shape) == shape
            assert _rel(x_got, x_ref) < tol, (dt, mode, layout)
