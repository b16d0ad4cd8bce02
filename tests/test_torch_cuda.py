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
from l3ster_tpu_torch.ops.qp import (
    qp_algebra_const,
    qp_algebra_const_lattice,
    qp_algebra_const_lattice_plain,
    qp_algebra_const_plain,
)
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
@pytest.mark.parametrize("dim, c, n_eq", [(2, 3, 4), (3, 4, 7)])
def test_qp_kernel_lattice_layout_matches_plain(cuda, dim, c, n_eq):
    """The per-QP kernel on the lattice chain's (d1*c, EQ) row stack against
    its plain version (f64 on the CPU), with a ragged last block."""
    from l3ster_tpu_torch.ops import qp

    EQ = 5 * 256 + 77
    rng = np.random.default_rng(10 + dim)
    A = _sparse_A(rng, dim + 1, n_eq, c)
    g = torch.as_tensor(rng.normal(size=((dim + 1) * c, EQ)))
    ji = torch.as_tensor(rng.normal(size=(dim * dim, EQ)) * 0.1 + np.eye(dim).reshape(-1, 1))
    w = torch.as_tensor(rng.uniform(0.5, 1.0, EQ))
    ref = qp_algebra_const_lattice_plain(A, g, ji, w)
    for dt, tol in TOLS:
        n0 = qp.launch_count
        got = qp_algebra_const_lattice(A, *(x.to(cuda, dt) for x in (g, ji, w)))
        torch.cuda.synchronize()
        assert qp.launch_count == n0 + 1
        assert got.shape == g.shape and _rel(got.cpu(), ref) < tol, dt


def _qp_case(rng, layout, dim, c, n_eq, E, Q):
    """Inputs of the per-QP kernel in one layout, f64 on the CPU: A, G, J^-1
    (dim, dim, EQ) and w."""
    EQ = E * Q
    A = _sparse_A(rng, dim + 1, n_eq, c)
    G = rng.normal(size=(E, c, dim + 1, Q) if layout == "dense" else ((dim + 1) * c, EQ))
    ji = rng.normal(size=(dim, dim, EQ)) * 0.1 + np.eye(dim)[:, :, None]
    return A, G, ji, rng.uniform(0.5, 1.0, EQ)


def _on_card(x: np.ndarray, dt, offset: int):
    """x on the card in dtype dt, as a view ``offset`` values into its storage."""
    flat = torch.zeros(x.size + offset, dtype=dt, device="cuda")
    flat[offset:] = torch.as_tensor(x.reshape(-1), dtype=dt)
    return flat[offset:].view(x.shape)


def _qp_check(layout, A, G, ji, w, offset=0):
    """Each dtype's kernel result against the plain version (f64 on the CPU),
    one launch a call; ``offset`` > 0 gives inputs that are not 16-byte aligned."""
    from l3ster_tpu_torch.ops import qp

    dim = ji.shape[0]
    if layout == "dense":
        kern, plain, args = qp_algebra_const, qp_algebra_const_plain, (G, ji, w)
    else:
        kern, plain, args = qp_algebra_const_lattice, qp_algebra_const_lattice_plain, (G, ji.reshape(dim * dim, -1), w)
    ref = plain(A, *(torch.as_tensor(a) for a in args))
    for dt, tol in TOLS:
        n0 = qp.launch_count
        got = kern(A, *(_on_card(a, dt, offset) for a in args))
        torch.cuda.synchronize()
        assert qp.launch_count == n0 + 1
        assert got.shape == ref.shape and _rel(got.cpu(), ref) < tol, dt


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "lattice"])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("c", [1, 3, 4, 5])
@pytest.mark.parametrize("E, Q", [(37, 64), (9, 125), (3, 27)])
def test_qp_kernel_layouts_channels_and_widths(cuda, layout, dim, c, E, Q):
    """The per-QP kernel in both layouts at the compiled channel counts (1, 3,
    4) and one run-time count (5), with 16-byte copies (Q = 64), single-value
    copies (Q = 125, E*Q odd) and fewer QPs than one tile (E*Q = 81), against
    its plain version."""
    rng = np.random.default_rng(100 * dim + 10 * c + Q)
    _qp_check(layout, *_qp_case(rng, layout, dim, c, 2 * c + 1, E, Q))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "lattice"])
@pytest.mark.parametrize("dim, c, n_eq", [(2, 3, 4), (3, 4, 7)])
def test_qp_kernel_unaligned_views(cuda, layout, dim, c, n_eq):
    """Inputs that are views one value into their storage (not 16-byte
    aligned) take the single-value copies of the same kernel."""
    rng = np.random.default_rng(7 + dim)
    _qp_check(layout, *_qp_case(rng, layout, dim, c, n_eq, 21, 64), offset=1)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "lattice"])
@pytest.mark.parametrize("c, n_eq, nbuf", [(8, 15, 2), (12, 20, 1)])
def test_qp_kernel_shorter_rings(cuda, layout, c, n_eq, nbuf):
    """Wide multi-RHS stackings (dim 3): in f64 the full ring does not fit in
    shared memory and the kernel runs a ring of two tiles (refilled after the
    stores) or of one."""
    from l3ster_tpu_torch.ops._cuda import coefficient_tables
    from l3ster_tpu_torch.ops.qp import _tile_shape, launch_shape

    rng = np.random.default_rng(c)
    case = _qp_case(rng, layout, 3, c, n_eq, 5, 64)
    assert launch_shape(3, c, n_eq, len(coefficient_tables(case[0])[3]), 8, _tile_shape()[1])["nbuf"] == nbuf
    _qp_check(layout, *case)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "lattice"])
@pytest.mark.parametrize("n_nz, tile", [(900, 128), (1792, 128)])
@pytest.mark.parametrize("E, Q", [(40, 64), (9, 125)])
def test_qp_kernel_smaller_tiles(cuda, layout, n_nz, tile, E, Q):
    """The widest multi-RHS stacking (dim 3, c = 16, n_eq = 28) with 900 and
    all 1,792 entries of A nonzero: one 256-QP f64 tile does not fit in shared memory,
    and the kernel runs 128-QP tiles, against its plain version to 1e-11
    (f64) and 2e-5 (f32, which keeps the 256-QP tile); the constant tables'
    limits are those the host checks."""
    from l3ster_tpu_torch.ops._cuda import CA_LIMITS, coefficient_tables
    from l3ster_tpu_torch.ops.qp import _library, _tile_shape, kernel_occupancy, launch_shape

    lib = _library()
    assert (lib.ca_max_entries(), lib.ca_max_equations(), lib.ca_max_slots()) == CA_LIMITS
    rng = np.random.default_rng(n_nz + Q)
    A, G, ji, w = _qp_case(rng, layout, 3, 16, 28, E, Q)
    A = np.zeros_like(A)
    flat = A.reshape(-1)
    flat[rng.choice(flat.size, n_nz, replace=False)] = rng.normal(size=n_nz)
    assert len(coefficient_tables(A)[3]) == n_nz
    assert launch_shape(3, 16, 28, n_nz, 8, _tile_shape()[1])["tile"] == tile
    occ = kernel_occupancy(torch.float64, A, 3, 16, E * Q, layout == "lattice", device=cuda)
    assert (occ["tile"], occ["threads"]) == (tile, tile) and occ["blocks_per_sm"] >= 1
    _qp_check(layout, A, G, ji, w)


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


def _cylinder_system(strategy, device, n_shards=0, devices=None):
    """The small cylinder problem (p = 2, f64); on ``n_shards`` shards of a
    DistributedSystem, placed with ``devices``, when given."""
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
    if n_shards:
        system = lp.make_distributed_system(
            mesh, problem, bcs, params, n_shards=n_shards, dtype=torch.float64, device=device, devices=devices
        )
    else:
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


def _box_system(kernel, device, order=3, n_1d=3, strategy=lp.OperatorEvaluationStrategy.MATRIX_FREE,
                cond=lp.CondensationPolicy.NONE, dtype=torch.float64):
    mesh = lp.generate_mesh(lp.make_cube_mesh(np.linspace(0.0, 1.0, n_1d)), order=order)
    problem = lp.ProblemDefinition(4, [0])
    bcs = lp.BCDefinition(problem)
    bcs.define_dirichlet([5, 6], [0])
    params = lp.AlgebraicSystemParams(eval_strategy=strategy, cond_policy=cond)
    system = lp.make_algebraic_system(mesh, problem, bcs, params, dtype=dtype, device=device)
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
    _check_zsweep_shape(cuda, p, qo, ne, RQ, mode, layout)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "ne,RQ,mode", [(18, 1296, "const-diag"), (36, 5184, "var-full"), (18, 1296, "var-full"), (36, 5184, "const-diag")]
)
def test_fused_z_sweep_order1_shapes_match_plain(cuda, ne, RQ, mode):
    """The z-sweep at the order-1 multigrid levels' shapes (p = 1, QO = 2:
    two node rows and two QP rows a layer): the bench's level 1 (n1z = 19,
    S = 36, RQ = 1,296, const+diag) and the var 12^3 box's level 1 (n1z = 37,
    S = 72, RQ = 5,184, var+full), each also in the other mode."""
    _check_zsweep_shape(cuda, 1, 2, ne, RQ, mode, "cz")


def _check_zsweep_shape(cuda, p, qo, ne, RQ, mode, layout):
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


@pytest.mark.cuda
@pytest.mark.parametrize("var", [False, True])
def test_lowordermg_vcycle_cuda_matches_cpu(cuda, var):
    """One LowOrderMG V-cycle in f64 on the card against the same on the CPU,
    in the lattice layout, with an order-1 matrix-free level between the
    fine level and the coarse inverse (p = 2 on 4^3 hexes: 9, 5 and 3 nodes
    an axis), so the order-1 level runs the z-sweep kernel; to 1e-11."""
    from l3ster_tpu_torch.ops import zsweep

    mg = lp.LowOrderMG(coarse_max_dofs=200)
    kernel = _var_diffusion if var else _diffusion_3d
    systems = {d: _box_system(kernel, d, order=2, n_1d=5) for d in (cuda, "cpu")}
    r = torch.as_tensor(np.random.default_rng(10).normal(size=(systems["cpu"].n_dofs, 1)))
    out = {}
    for d, s in systems.items():
        apply, consts = mg.setup_parts(s, layout="lattice")
        assert all(c.device.type == torch.device(d).type for c in consts if isinstance(c, torch.Tensor))
        before = zsweep.launch_count
        out[d] = apply(s.to_lattice_layout(r.to(d)), *consts).cpu()
        if d is cuda:
            torch.cuda.synchronize()
            assert zsweep.launch_count > before
    assert _rel(out[cuda], out["cpu"]) < 1e-11


@pytest.mark.cuda
def test_assembled_system_cuda_matches_cpu(cuda):
    """An AssembledSystem (p = 3, 2^3 hexes) on the card against the CPU in
    f64: values, SpMV, diagonal and the eliminated CSR data."""
    G = lp.OperatorEvaluationStrategy.GLOBAL_ASSEMBLY
    gpu, cpu = _box_system(_var_diffusion, cuda, strategy=G), _box_system(_var_diffusion, "cpu", strategy=G)
    assert isinstance(gpu, lp.AssembledSystem) and gpu.data.device.type == cuda.type
    x = torch.as_tensor(np.random.default_rng(11).normal(size=(cpu.n_dofs, 2)))
    assert _rel(gpu.operator()(x.to(cuda)).cpu(), cpu.operator()(x)) < 1e-11
    assert _rel(gpu.data.cpu(), cpu.data) < 1e-11
    assert _rel(gpu.diagonal().cpu(), cpu.diagonal()) < 1e-11
    assert _rel(gpu.eliminated_csr()[0].cpu(), cpu.eliminated_csr()[0]) < 1e-11


def _karman_system(device, strategy="AUTO", seed=15):
    """The mini Karman case (``tests/test_pmg.py:_cyl_mesh(order=2)``): the
    BDF2 Navier-Stokes operator reading four seeded fields, matrix-free, f64."""
    from l3ster_tpu_torch.models.kernels import navier_stokes_outlet_bc, navier_stokes_uvop_2d

    mesh = lp.generate_mesh(
        lp.make_cylinder_in_channel_2d(
            left_offset=4.0, right_offset=6.0, bottom_offset=3.0, top_offset=3.0, n_circumf=16, n_radial=4,
            n_left=3, n_right=6, n_bottom=2, n_top=2, q_radial=1.3, q_right=1.1,
        ),
        order=2,
    )
    problem = lp.ProblemDefinition(4, [0])
    bcs = lp.BCDefinition(problem)
    bcs.define_dirichlet([3, 1, 2, 5], [0, 1])
    params = lp.AlgebraicSystemParams(eval_strategy=lp.OperatorEvaluationStrategy.MATRIX_FREE)
    system = lp.make_algebraic_system(mesh, problem, bcs, params, dtype=torch.float64, device=device)
    fields = np.random.default_rng(seed).normal(scale=0.05, size=(mesh.n_nodes, 4))
    fields[:, [0, 2]] += 1.0
    man = lp.interop.solution_manager_from_numpy(mesh, fields, device=device)
    opts = lp.AssemblyOptions(value_order=1, derivative_order=1, eval_strategy=getattr(lp.LocalEvalStrategy, strategy))
    system.begin_assembly()
    system.assemble_problem(navier_stokes_uvop_2d(0.02, dt=0.2), [0], man.field_access([0, 1, 2, 3]), options=opts)
    system.assemble_problem(navier_stokes_outlet_bc(0.02), [4], dof_inds=(0, 1, 3))
    system.end_assembly()
    return system


@pytest.mark.cuda
@pytest.mark.parametrize("strategy,kind", [("AUTO", "dense"), ("SUM_FACT", "sumfact")])
def test_karman_var_apply_cuda_matches_cpu(cuda, strategy, kind):
    """The field-coupled variable-coefficient applies (``dense`` under AUTO,
    ``sumfact``) in f64 on the card against the CPU: apply, diagonal and
    effective rhs, to 1e-11."""
    gpu, cpu = _karman_system(cuda, strategy), _karman_system("cpu", strategy)
    assert [d[0] for _, d in gpu._operators()[1]] == [kind, "direct"]
    x = torch.as_tensor(np.random.default_rng(16).normal(size=(cpu.n_dofs, 1)))
    assert _rel(gpu.operator()(x.to(cuda)).cpu(), cpu.operator()(x)) < 1e-11
    assert _rel(gpu.diagonal().cpu(), cpu.diagonal()) < 1e-11
    assert _rel(gpu.effective_rhs().cpu(), cpu.effective_rhs()) < 1e-11


@pytest.mark.cuda
def test_pmg_vcycle_cuda_matches_cpu(cuda):
    """One PMultigrid V-cycle on the Karman operator in f64 on the card (its
    Q1 coarse level assembled on the card, inverted on the host) against the
    CPU, from the same power-iteration start, to 1e-11."""
    r = torch.as_tensor(np.random.default_rng(17).normal(size=(_karman_system("cpu").n_dofs, 1)))
    out = {}
    for d in (cuda, "cpu"):
        s = _karman_system(d)
        apply, consts = lp.PMultigrid().setup_parts(s)
        assert all(c.device.type == torch.device(d).type for c in consts if isinstance(c, torch.Tensor))
        out[d] = apply(r.to(d), *consts).cpu()
    assert _rel(out[cuda], out["cpu"]) < 1e-11


@pytest.mark.cuda
def test_condensed_system_cuda_matches_cpu(cuda):
    """An ELEMENT_BOUNDARY-condensed system (p = 3, 2^3 hexes, f64) on the card
    against the CPU: the Schur-reduced data and effective rhs, and the interiors
    recovered from one boundary vector, to 1e-11."""
    G, EB = lp.OperatorEvaluationStrategy.GLOBAL_ASSEMBLY, lp.CondensationPolicy.ELEMENT_BOUNDARY
    gpu, cpu = (_box_system(_var_diffusion, d, strategy=G, cond=EB) for d in (cuda, "cpu"))
    assert gpu.n_dofs == cpu.n_dofs < 4 * gpu.mesh.n_nodes
    assert _rel(gpu.data.cpu(), cpu.data) < 1e-11
    assert _rel(gpu.effective_rhs().cpu(), cpu.effective_rhs()) < 1e-11
    x = torch.as_tensor(np.random.default_rng(18).normal(size=(cpu.n_dofs, 1)))
    gpu.set_solution_vector(x.to(cuda))
    cpu.set_solution_vector(x)
    (_, _, vg), = gpu.recover_condensed_solution()
    (_, _, vc), = cpu.recover_condensed_solution()
    assert _rel(vg.cpu(), vc) < 1e-11


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["SGS", "ILU0", "ILUT"])
def test_triangular_preconditioners_cuda_match_cpu(cuda, name):
    """The level-scheduled triangular solves on the card: SGS, ILU0 and ILUT
    applies (f64) of an assembled system against the CPU, to 1e-11."""
    G = lp.OperatorEvaluationStrategy.GLOBAL_ASSEMBLY
    r = torch.as_tensor(np.random.default_rng(19).normal(size=(_box_system(_var_diffusion, "cpu", strategy=G).n_dofs, 2)))
    out = {}
    for d in (cuda, "cpu"):
        apply, consts = getattr(lp, name)().setup_parts(_box_system(_var_diffusion, d, strategy=G))
        assert apply.n_levels > 2
        out[d] = apply(r.to(d), *consts).cpu()
    assert _rel(out[cuda], out["cpu"]) < 1e-11


@pytest.mark.cuda
def test_linear_solve_raises_on_kernel_kind_with_grad(cuda):
    """A const that requires grad and reaches a hand-written kernel (the
    bench's z-sweep) raises, naming ROADMAP.md, rather than return a
    gradient without the kernel's part; with respect to b the gradient runs."""
    gpu = _box_system(_diffusion_3d, cuda, order=2)
    fn, (ops,) = gpu.operator_parts()
    (c, d), rest = ops[0], ops[1:]
    assert d[0] == "lattice_sf_const_diag"
    jx = d[3].clone().requires_grad_()
    ops_g = [(c, d[:3] + (jx,) + d[4:])] + list(rest)
    b = gpu.effective_rhs()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        lp.linear_solve(fn, (ops_g,), b, tol=1e-10)
    bg = b.clone().requires_grad_()
    u = lp.linear_solve(fn, (ops,), bg, tol=1e-12, max_iters=3000)
    u.pow(2).sum().backward()
    assert torch.isfinite(bg.grad).all() and bg.grad.abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards,grid", [(4, None), (4, (2, 2))])
def test_box_apply_cuda_matches_plain(cuda, n_shards, grid):
    """The box decomposition of the bench problem (p = 3 on 4^3 hexes; the
    4-slab windows uneven) on the card, one z-sweep launch per shard and
    apply, in f32 against the same box on the CPU (the plain z-sweep) in f64,
    to 2e-5 of max |ref|; ghost and padding planes zero."""
    from l3ster_tpu_torch.ops import zsweep

    boxes = {}
    for d, dt in ((cuda, torch.float32), ("cpu", torch.float64)):
        boxes[d] = lp.box_parallelize(_box_system(_diffusion_3d, d, n_1d=5, dtype=dt), n_shards=n_shards, grid=grid)
    xg = torch.as_tensor(np.random.default_rng(21).normal(size=(boxes["cpu"].n_dofs, 1)))
    x_st = boxes["cpu"]._to_slabs(xg)
    ref = boxes["cpu"].operator()(x_st)
    before = zsweep.launch_count
    got = boxes[cuda].operator()(x_st.to(cuda, torch.float32))
    torch.cuda.synchronize()
    assert zsweep.launch_count - before == n_shards
    assert _rel(got.cpu(), ref) < 2e-5
    assert bool((got.cpu()[boxes["cpu"]._own_st == 0] == 0).all())


@pytest.mark.cuda
def test_distributed_dense_const_cuda_matches_plain(cuda):
    """The distributed ``dense_const`` apply of a small cylinder problem (p = 2,
    4 shards) on the card, through the per-QP kernel, in f32 against the
    same system on the CPU (the plain per-QP algebra) in f64, to 2e-5."""
    from l3ster_tpu_torch.ops import qp

    mesh = lp.generate_mesh(
        lp.make_cylinder_in_channel_3d(
            distz=np.linspace(-1, 1, 3), left_offset=4.0, right_offset=6.0, bottom_offset=3.0, top_offset=3.0,
            n_circumf=16, n_radial=4, n_left=3, n_right=6, n_bottom=2, n_top=2,
        ),
        order=2,
    )
    systems = {}
    for d, dt in ((cuda, torch.float32), ("cpu", torch.float64)):
        problem = lp.ProblemDefinition(4, [0])
        bcs = lp.BCDefinition(problem)
        bcs.define_dirichlet([3, 4, 5], [0])
        params = lp.AlgebraicSystemParams(eval_strategy=lp.OperatorEvaluationStrategy.MATRIX_FREE)
        s = lp.make_distributed_system(mesh, problem, bcs, params, n_shards=4, dtype=dt, device=d)
        s.begin_assembly()
        s.assemble_problem(lp.wrap_domain_equation_kernel(_diffusion_3d, lp.KernelParams(3, 7, 4)), [0])
        s.assemble_problem(lp.wrap_boundary_equation_kernel(_adiabatic_3d, lp.KernelParams(3, 1, 4)), [1, 2, 6, 7])
        s.end_assembly()
        systems[d] = s
    assert [d[0] for _, d, _ in systems[cuda]._operators()][0] == "dense_const"
    cpu = systems["cpu"]
    x = np.random.default_rng(22).normal(size=(cpu.n_shards, cpu.n_loc1, 1)) * cpu._owned_mask.numpy()[:, :, None]
    fc, cc = cpu.operator_parts()
    ref = fc(torch.as_tensor(x), *cc)
    fg, cg = systems[cuda].operator_parts()
    before = qp.launch_count
    got = fg(torch.as_tensor(x, dtype=torch.float32, device=cuda), *cg)
    torch.cuda.synchronize()
    assert qp.launch_count > before
    assert _rel(got.cpu(), ref) < 2e-5


@pytest.mark.cuda
def test_zsweep_raises_on_empty_window(cuda):
    """A window with no element layer (a box shard padded to zero planes)
    raises in the wrapper's setup instead of falling back to the plain
    sweep, and launches nothing."""
    from l3ster_tpu_torch.ops import zsweep

    A = np.zeros((4, 7, 4))
    A[1, 0, 1] = -1.0
    before = zsweep.launch_count
    with pytest.raises((ValueError, RuntimeError)):
        Ng, Dg = banded_tables(3, 6, 0)
        tabs = zsweep_tables(Ng.T, Dg.T, torch.float32, cuda)
        b = torch.zeros((4, 1, 16), device=cuda)
        g = ("full", torch.ones((9, 0, 16), device=cuda), torch.zeros((0, 16), device=cuda))
        fused_z_sweep(A, b, b, b, g, tabs)
    assert zsweep.launch_count == before


def _card_devices(n: int) -> list:
    """Placement entries on the cards: the first min(D, n) of D >= 2 cards,
    else n entries of the one card."""
    D = torch.cuda.device_count()
    return [f"cuda:{i}" for i in range(min(D, n))] if D >= 2 else ["cuda:0"] * n


def _sync_cards() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


@pytest.mark.cuda
def test_placed_distributed_system_on_cards(cuda):
    """The small cylinder problem (AUTO: ``dense_const`` with the per-QP
    kernel, f64) on 4 shards placed on the cards (one placement group an
    entry: every card, or four groups of the one card): the apply and the
    effective rhs equal the one-group system's to 1e-12 with each group's
    part on its card and the kernel launched on every card; CG + Jacobi
    within one iteration and 1e-10 of it."""
    from l3ster_tpu_torch.ops import qp

    devices = _card_devices(4)
    one, placed = _cylinder_system("AUTO", cuda, n_shards=4), _cylinder_system("AUTO", None, n_shards=4, devices=devices)
    x = torch.as_tensor(np.random.default_rng(23).normal(size=(4, one.n_loc1, 1)), device=cuda)
    x = x * one._owned_mask[:, :, None]
    (f1, c1), (f4, c4) = one.operator_parts(), placed.operator_parts()
    qp.launches_by_device.clear()
    y = f4(x, *c4)
    _sync_cards()
    assert [p.device for p in y.parts] == [torch.device(d) for d in devices]
    assert set(qp.launches_by_device) == {torch.device(d).index for d in devices}
    assert _rel(y.cpu(), f1(x, *c1).cpu()) < 1e-12
    assert _rel(placed.effective_rhs().cpu(), one.effective_rhs().cpu()) < 1e-12
    opts = lp.IterSolverOpts(tol=1e-10, max_iters=5000)
    r1, r4 = one.solve(lp.CG(opts, precond=lp.Jacobi())), placed.solve(lp.CG(opts, precond=lp.Jacobi()))
    assert r4.converged and abs(r4.num_iters - r1.num_iters) <= 1
    assert _rel(placed.x.cpu(), one.x.cpu()) < 1e-10


@pytest.mark.cuda
def test_placed_box_on_cards(cuda):
    """The bench box (p = 3 on 4^3 hexes, f64) at 2 z slabs placed on the
    cards: its apply equals the one-group box's to 1e-12, one z-sweep launch
    a shard, on its card."""
    from l3ster_tpu_torch.ops import zsweep

    single = _box_system(_diffusion_3d, cuda, n_1d=5)
    devices = _card_devices(2)
    one, placed = lp.box_parallelize(single, n_shards=2), lp.box_parallelize(single, n_shards=2, devices=devices)
    xg = torch.as_tensor(np.random.default_rng(24).normal(size=(single.n_dofs, 1)), device=cuda)
    y1 = one._from_slabs(one.operator()(one._to_slabs(xg)))
    zsweep.launches_by_device.clear()
    y = placed.operator()(placed._to_slabs(xg))
    _sync_cards()
    assert [p.device for p in y.parts] == [torch.device(d) for d in devices]
    want = {}
    for d in devices:
        want[torch.device(d).index] = want.get(torch.device(d).index, 0) + 1
    assert zsweep.launches_by_device == want
    assert _rel(placed._from_slabs(y).cpu(), y1.cpu()) < 1e-12
