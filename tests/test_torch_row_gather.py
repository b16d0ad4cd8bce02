"""The node-row gather and scatter-add of the gather apply (``ops/rows.py``, ``csrc/row_gather.cu``).

On the CPU the wrappers take their plain versions, checked here against the
torch indexing and ``index_add_`` they replace, and the gather apply's
channel-major route against the node-major one.  The tests marked ``cuda``
hold the kernels to the same operations on the card: the gather bit for
bit, the scatter to rounding, in both layouts, f32 and f64, 2 to 4
unknowns, a multi-RHS column and unaligned bases; then one apply of a small
unstructured mesh launches one gather and one scatter per node-row
contribution, and no PyTorch gather or index kernel.  The file imports
neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_row_gather.py
"""

import numpy as np
import pytest
import torch

import l3ster_tpu_torch as lp
from l3ster_tpu_torch.ops import rows
from l3ster_tpu_torch.ops.rows import gather_rows, scatter_rows_add

CYL = dict(
    distz=np.linspace(-1, 1, 3), left_offset=4.0, right_offset=6.0, bottom_offset=3.0,
    top_offset=3.0, n_circumf=16, n_radial=4, n_left=3, n_right=6, n_bottom=2, n_top=2,
)
CASES = ("contiguous", "column", "unaligned")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _rows_case(case: str, c: int, dtype, device, seed: int, n_rows: int = 997, E: int = 301, n: int = 27):
    """(x2 (n_rows, c) view, idx (E, n) int32): contiguous rows, the second
    column of a 3-column block (rows and unknowns strided), or rows whose
    base is one value off a 16-byte boundary."""
    rng = np.random.default_rng(seed)
    idx = torch.tensor(rng.integers(0, n_rows, (E, n)), dtype=torch.int32, device=device)
    if case == "column":
        x2 = torch.tensor(rng.normal(size=(n_rows * c, 3)), dtype=dtype, device=device)[:, 1].view(n_rows, c)
    elif case == "unaligned":
        x2 = torch.tensor(rng.normal(size=n_rows * c + 1), dtype=dtype, device=device)[1:].view(n_rows, c)
    else:
        x2 = torch.tensor(rng.normal(size=(n_rows, c)), dtype=dtype, device=device)
    return x2, idx


def _block(x2, idx, channel_major: bool):
    """The element block by torch indexing, in the layout asked for."""
    x_loc = x2[idx.long()]
    return x_loc.transpose(1, 2).contiguous() if channel_major else x_loc


def _index_add(n_rows: int, c: int, idx, y, channel_major: bool, dtype=None):
    """flat (n_rows, c) by index_add_ of y's rows, in ``dtype`` (default y's)."""
    y = (y.transpose(1, 2) if channel_major else y).to(dtype or y.dtype)
    flat = torch.zeros((n_rows, c), dtype=y.dtype, device=y.device)
    return flat.index_add_(0, idx.reshape(-1).long(), y.reshape(-1, c))


@pytest.mark.parametrize("channel_major", [False, True])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("c", [2, 3, 4])
def test_plain_gather_and_scatter_match_indexing(channel_major, case, c):
    """The CPU path: the gather is torch indexing, the scatter index_add_,
    in both layouts, and both agree with numpy's take and add.at."""
    x2, idx = _rows_case(case, c, torch.float64, "cpu", c)
    got = gather_rows(x2, idx, channel_major)
    assert torch.equal(got, _block(x2, idx, channel_major))
    ref = np.asarray(x2)[np.asarray(idx)]
    assert np.array_equal(np.asarray(got), ref.transpose(0, 2, 1) if channel_major else ref)
    flat = torch.zeros_like(x2, memory_format=torch.contiguous_format)
    scatter_rows_add(flat, idx, got, channel_major)
    expect = np.zeros(x2.shape)
    np.add.at(expect, np.asarray(idx).reshape(-1), ref.reshape(-1, c))
    assert np.abs(np.asarray(flat) - expect).max() <= 1e-13 * np.abs(expect).max()


@pytest.mark.parametrize(
    "dtype, c, case, channel_major, expect",
    [
        (torch.float32, 4, "contiguous", False, (4, 4)),
        (torch.float32, 4, "contiguous", True, (4, 4)),
        (torch.float32, 2, "contiguous", False, (2, 2)),
        (torch.float32, 3, "contiguous", False, (1, 1)),
        (torch.float32, 4, "column", True, (1, 4)),
        (torch.float32, 4, "unaligned", False, (1, 1)),
        (torch.float64, 2, "contiguous", False, (2, 1)),
        (torch.float64, 4, "contiguous", True, (2, 1)),
    ],
)
def test_vector_width_follows_dtype_unknowns_and_alignment(dtype, c, case, channel_major, expect):
    """The widths the wrappers pass the kernels, (gather, scatter): one vector
    a row of at most 16 bytes where the unknowns are contiguous and aligned,
    f32 atomics of 4 or 2, f64 atomics one value at a time."""
    x2, idx = _rows_case(case, c, dtype, "cpu", 7)
    srow, sunk = x2.stride()
    out = torch.empty((idx.shape[0], idx.shape[1], c), dtype=dtype)
    g = rows._vector_width(c, srow, x2 if channel_major else (x2, out), 16 // x2.element_size() if sunk == 1 else 1)
    flat = torch.zeros(x2.numel() + 1, dtype=dtype)[int(case == "unaligned") :][: x2.numel()]
    s = rows._vector_width(c, c, flat, 4 if dtype == torch.float32 else 1)
    assert (g, s) == expect


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


def _varying_3d(inp, out):
    """_diffusion_3d with a coefficient that varies in space: A per QP."""
    _diffusion_3d(inp, out)
    out.operators[0][1, 1] = -1.0 - 0.1 * inp.point.x


def _t_equals_x(inp, out):
    out[0] = inp.point.x


def _system(strategy: str, device, dtype=torch.float64, dirichlet: bool = False):
    """3D diffusion on the small cylinder mesh (304 hexes, p = 2, 13,320
    dofs), its volume under ``strategy`` (``AUTO_VAR``: AUTO with a varying
    coefficient), value-only adiabatic walls and caps (direct, on restricted
    dof gathers); with ``dirichlet``, T = x on the inlet, outlet and
    cylinder, so that the operator is invertible."""
    mesh = lp.generate_mesh(lp.make_cylinder_in_channel_3d(**CYL), order=2)
    problem = lp.ProblemDefinition(4, [0])
    params = lp.AlgebraicSystemParams(eval_strategy=lp.OperatorEvaluationStrategy.MATRIX_FREE)
    bcs = None
    if dirichlet:
        bcs = lp.BCDefinition(problem)
        bcs.define_dirichlet([3, 4, 5], [0])
    system = lp.make_algebraic_system(mesh, problem, bcs, params, dtype=dtype, device=device)
    if dirichlet:
        system.set_dirichlet_bc_values(
            lp.wrap_boundary_residual_kernel(_t_equals_x, lp.KernelParams(3, 1)), [3, 4, 5], [0]
        )
    system.begin_assembly()
    system.assemble_problem(
        lp.wrap_domain_equation_kernel(_varying_3d if strategy == "AUTO_VAR" else _diffusion_3d, lp.KernelParams(3, 7, 4)),
        [0], options=lp.AssemblyOptions(eval_strategy=getattr(lp.LocalEvalStrategy, strategy.removesuffix("_VAR"))),
    )
    system.assemble_problem(lp.wrap_boundary_equation_kernel(_adiabatic_3d, lp.KernelParams(3, 1, 4)), [1, 2, 6, 7])
    system.end_assembly()
    return system


def _scaled_w(ops, s):
    """ops with the weights w (``d[3]`` of every gather-family kind) of each
    node-row contribution scaled by s: a const on the rows path."""
    return [(c, d[:3] + (d[3] * s,) + d[4:]) if d[-1][0] == "rows" else (c, d) for c, d in ops]


def _node_major_apply(system, x, ops=None):
    """The unconstrained operator with every node-row contribution gathered
    by torch indexing and added by index_add_ in node-major blocks: the
    route the gather apply took before its layouts followed the kind."""
    fn, (ops0,) = system.raw_parts()
    ops = ops0 if ops is None else ops
    y = fn(x, [(c, d) for c, d in ops if d[-1][0] != "rows"])
    for c, d in ops:
        if d[-1][0] == "rows":
            _, idx, n_rows = d[-1]
            n_unk = c.elem_dofs.shape[2]
            for r in range(x.shape[1]):
                y_loc = system._local_apply(c, d, x[:, r].reshape(n_rows, n_unk)[idx.long()])
                y[:, r] += _index_add(n_rows, n_unk, idx, y_loc, False).reshape(-1)
    return y


KINDS = [("AUTO", "dense_const"), ("AUTO_VAR", "dense"), ("SUM_FACT", "sumfact_const"), ("DIRECT", "direct")]


@pytest.mark.parametrize("strategy, kind", KINDS)
def test_gather_apply_layouts_match_node_major_route(strategy, kind):
    """On the CPU, the apply's node-row contributions in the layout their
    kind takes (channel-major for the dense kinds) equal the node-major
    route through indexing and index_add_, on two right-hand sides."""
    system = _system(strategy, "cpu")
    fn, (ops,) = system.raw_parts()
    assert ops[0][1][0] == kind and ops[0][1][-1][0] == "rows" and ops[0][1][-1][1].dtype == torch.int32
    x = torch.as_tensor(np.random.default_rng(3).normal(size=(system.n_dofs, 2)))
    ref = _node_major_apply(system, x)
    assert float((fn(x, ops) - ref).abs().max() / ref.abs().max()) < 1e-13


@pytest.mark.parametrize("channel_major", [False, True])
def test_gather_and_scatter_gradients(channel_major):
    """Each is the other's backward: gradcheck (first and second order) of
    the gather with respect to the rows, and of the in-place scatter into a
    view with respect to the block and the accumulator's history."""
    rng = np.random.default_rng(11)
    idx = torch.tensor(rng.integers(0, 11, (5, 7)), dtype=torch.int32)
    x2 = torch.tensor(rng.normal(size=(11, 3)), requires_grad=True)
    y = torch.tensor(rng.normal(size=(5, 3, 7) if channel_major else (5, 7, 3)), requires_grad=True)

    def scattered(x2, y):
        flat = x2.reshape(-1) * 2.0  # an accumulator with a history, added to in place through a view
        scatter_rows_add(flat.view(11, 3), idx, y, channel_major)
        return flat

    assert torch.autograd.gradcheck(lambda x2: gather_rows(x2, idx, channel_major), (x2,))
    assert torch.autograd.gradgradcheck(lambda x2: gather_rows(x2, idx, channel_major) ** 2, (x2,))
    assert torch.autograd.gradcheck(scattered, (x2, y))
    assert torch.autograd.gradgradcheck(lambda x2, y: scattered(x2, y) ** 2, (x2, y))


@pytest.mark.parametrize("strategy, kind", KINDS)
def test_gather_apply_gradients_match_node_major_route(strategy, kind):
    """On the CPU, the gradients of <v, K(w s) x> with respect to x and to a
    scale s of the node-row contribution's weights, through the row
    gather and scatter's backward, equal those through torch indexing and
    index_add_ in the node-major route."""
    system = _system(strategy, "cpu")
    fn, (ops,) = system.raw_parts()
    rng = np.random.default_rng(4)
    v, x_host = (rng.normal(size=(system.n_dofs, 2)) for _ in range(2))
    v = torch.as_tensor(v)
    grads = []
    for apply in (lambda x, o: fn(x, o), lambda x, o: _node_major_apply(system, x, o)):
        x = torch.tensor(x_host, requires_grad=True)
        s = torch.tensor(1.1, dtype=torch.float64, requires_grad=True)
        grads.append(torch.autograd.grad((v * apply(x, _scaled_w(ops, s))).sum(), (x, s)))
    (gx, gs), (rx, rs) = grads
    assert float((gx - rx).abs().max() / rx.abs().max()) < 1e-13
    assert abs(gs.item() - rs.item()) <= 1e-12 * abs(rs.item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("channel_major", [False, True])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("c", [2, 3, 4])
def test_gather_kernel_matches_indexing_bit_for_bit(cuda, dtype, channel_major, case, c):
    x2, idx = _rows_case(case, c, dtype, cuda, 10 + c)
    rows.launch_count.clear()
    got = gather_rows(x2, idx, channel_major)
    torch.cuda.synchronize()
    assert rows.launch_count == {("gather", "channel_major" if channel_major else "node_major"): 1}
    assert got.is_contiguous() and torch.equal(got, _block(x2, idx, channel_major))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-6), (torch.float64, 1e-14)])
@pytest.mark.parametrize("channel_major", [False, True])
@pytest.mark.parametrize("c, unaligned", [(2, False), (3, False), (4, False), (4, True)])
def test_scatter_kernel_matches_index_add(cuda, dtype, tol, channel_major, c, unaligned):
    """Equal to index_add_ to rounding: the atomics add the same terms in
    another order.  Compared with index_add_ in f64 of the same values, and
    with index_add_ in the working dtype; ``unaligned``: an accumulator one
    value off a 16-byte boundary (scalar atomics)."""
    x2, idx = _rows_case("contiguous", c, dtype, cuda, 20 + c)
    n_rows = x2.shape[0]
    y = _block(x2, idx, channel_major) * 1.5 - 0.25
    flat = torch.zeros(n_rows * c + 1, dtype=dtype, device=cuda)[int(unaligned):][: n_rows * c].view(n_rows, c)
    flat += 1.0
    rows.launch_count.clear()
    scatter_rows_add(flat, idx, y, channel_major)
    torch.cuda.synchronize()
    assert rows.launch_count == {("scatter", "channel_major" if channel_major else "node_major"): 1}
    ref = _index_add(n_rows, c, idx, y, channel_major, torch.float64) + 1.0
    scale = float(ref.abs().max())
    assert float((flat.double() - ref).abs().max()) <= tol * scale
    same = _index_add(n_rows, c, idx, y, channel_major) + 1.0
    assert float((flat - same).abs().max()) <= 2 * tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("strategy, kind", KINDS)
def test_gather_apply_engages_row_kernels(cuda, strategy, kind):
    """One apply of the small unstructured mesh launches, per node-row
    contribution and right-hand side, one gather and one scatter in the
    layout of its kind; the volume's part runs no PyTorch gather or index
    kernel; the apply equals the CPU's on two right-hand sides."""
    from torch.profiler import ProfilerActivity, profile

    gpu, cpu = _system(strategy, cuda), _system(strategy, "cpu")
    fn, (ops,) = gpu.raw_parts()
    vol = [(c, d) for c, d in ops if d[-1][0] == "rows"]
    assert [d[0] for _, d in vol] == [kind]
    layout = "channel_major" if kind.startswith("dense") else "node_major"
    x = torch.as_tensor(np.random.default_rng(5).normal(size=(cpu.n_dofs, 2)))
    rows.launch_count.clear()
    y = gpu.operator()(x.to(cuda)).cpu()
    assert rows.launch_count == {("gather", layout): 2, ("scatter", layout): 2}
    ref = cpu.operator()(x)
    assert float((y - ref).abs().max() / ref.abs().max()) < 1e-11
    xg = x.to(cuda)
    fn(xg, vol)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(xg, vol)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_type.name == "CUDA"]
    assert any("rows_gather" in k for k in names) and any("rows_scatter_add" in k for k in names), names
    assert not [k for k in names if "vectorized_gather_kernel" in k or "indexFunc" in k], names


@pytest.mark.cuda
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("strategy, kind", [("AUTO_VAR", "dense"), ("SUM_FACT", "sumfact_const")])
def test_linear_solve_gradients_through_row_kernels(cuda, strategy, kind, symmetric):
    """linear_solve on the card through the row kernels, for the kinds whose
    local apply is plain torch: the gradients with respect to the rhs and to
    a scale s of the volume's weights (a const) against central differences
    of the solve, under CG and under GMRES, whose backward takes the apply's
    transpose from autograd through the gather and the scatter."""
    system = _system(strategy, cuda, dirichlet=True)
    fn, (ops,) = system.operator_parts()
    assert [d[0] for _, d in ops if d[-1][0] == "rows"] == [kind]
    M, mc = lp.Jacobi().setup_parts(system)
    b0 = system.effective_rhs()
    db = torch.as_tensor(np.random.default_rng(6).normal(size=tuple(b0.shape)), device=cuda)
    kw = dict(precond=M, precond_consts=mc, tol=1e-13, max_iters=20000, symmetric=symmetric, restart=100)

    def loss(s, b):
        return torch.sum(lp.linear_solve(fn, (_scaled_w(ops, s),), b, **kw) ** 2)

    s = torch.tensor(1.1, dtype=torch.float64, device=cuda, requires_grad=True)
    b = b0.clone().requires_grad_()
    rows.launch_count.clear()
    loss(s, b).backward()
    assert rows.launch_count[("gather", "channel_major" if kind == "dense" else "node_major")] > 0
    h = 1e-5
    with torch.no_grad():
        fd_s = (loss(s + h, b0) - loss(s - h, b0)) / (2 * h)
        fd_b = (loss(s, b0 + h * db) - loss(s, b0 - h * db)) / (2 * h)
    assert abs(s.grad.item() - fd_s.item()) <= 1e-6 * abs(fd_s.item())
    assert abs(float((b.grad * db).sum()) - fd_b.item()) <= 1e-6 * abs(fd_b.item())
