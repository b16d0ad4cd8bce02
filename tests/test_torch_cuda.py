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


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["single", "pair"])
def test_stage_kernel_matches_plain(cuda, form):
    """The stage kernel with ragged row and column tiles, in both forms."""
    from l3ster_tpu_torch.ops.stages import kstacked_matmul, kstacked_matmul_plain, stage_tables

    rng = np.random.default_rng(8)
    M = 1000
    T = stage_tables(6, 22, 3, "ND" if form == "single" else "NDT")
    K = T.shape[0] if form == "single" else T.shape[0] // 2
    x = torch.as_tensor(rng.normal(size=(M, K)), device=cuda)
    x2 = None if form == "single" else torch.as_tensor(rng.normal(size=(M, K)), device=cuda)
    Tt = torch.as_tensor(T, device=cuda)
    ref = kstacked_matmul_plain(x, x2, Tt, T.shape[1])
    for dt, tol in TOLS:
        got = kstacked_matmul(x.to(dt), None if x2 is None else x2.to(dt), Tt.to(dt), T.shape[1])
        torch.cuda.synchronize()
        assert tuple(got.shape) == (M, T.shape[1])
        assert _rel(got, ref) < tol, dt


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
