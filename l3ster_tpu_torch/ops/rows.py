"""Node-row gather and scatter-add of the gather-family apply: Hopper CUDA kernels and their plain versions.

The operator's vectors are (n_rows, c) node rows; an element's n local nodes
read rows ``idx`` (E, n) of int32.  :func:`gather_rows` copies them into the
element block, channel-major (E, c, n), the dense apply's basis-SGEMM
operand (``ops/dense_eval.py``), or node-major (E, n, c), the other kinds'
input; :func:`scatter_rows_add` adds an element block of either layout back
into a contiguous (n_rows, c) accumulator.  They replace no TPU kernel (the
JAX package leaves both to XLA); ``csrc/row_gather.cu`` has the design note.

Each runs its plain version (torch indexing and ``index_add_``) on CPU
tensors and launches its kernel on CUDA tensors or raises.  The two are
exact transposes of each other, so each is the other's backward: where
autograd records, they run as a ``torch.autograd.Function`` pair on either
device.  ``launch_count`` counts kernel launches by (``"gather"`` or
``"scatter"``, layout).
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from ._cuda import device_and_stream, load

__all__ = ["gather_rows", "gather_rows_plain", "scatter_rows_add", "scatter_rows_add_plain"]

# kernel launches by ("gather" | "scatter", "channel_major" | "node_major"); read and
# cleared by callers that check the path
launch_count: Counter = Counter()


def _layout(channel_major: bool) -> str:
    return "channel_major" if channel_major else "node_major"


def gather_rows_plain(x2: torch.Tensor, idx: torch.Tensor, channel_major: bool) -> torch.Tensor:
    """Plain torch version: x2 (n_rows, c) rows at idx (E, n), as (E, c, n)
    with ``channel_major`` (a transposed view) or (E, n, c)."""
    x_loc = x2[idx]
    return x_loc.transpose(1, 2) if channel_major else x_loc


def scatter_rows_add_plain(flat2: torch.Tensor, idx: torch.Tensor, y: torch.Tensor, channel_major: bool) -> None:
    """Plain torch version: flat2 (n_rows, c)[idx[e, a]] += y's row of (e, a),
    y (E, c, n) with ``channel_major``, else (E, n, c); in place."""
    y_nm = y.transpose(1, 2) if channel_major else y
    flat2.index_add_(0, idx.reshape(-1), y_nm.reshape(-1, flat2.shape[1]))


def gather_rows(x2: torch.Tensor, idx: torch.Tensor, channel_major: bool) -> torch.Tensor:
    """The element block of x2's rows at idx: the CUDA kernel for CUDA
    tensors (a new contiguous block), :func:`gather_rows_plain` for CPU
    tensors.  x2 (n_rows, c) may be any strided view, as a column of a
    multi-RHS block is.  idx must hold rows of x2: the card does not check
    (that would cost a reduction and a synchronize per call).  Differentiable
    with respect to x2 (its backward is :func:`scatter_rows_add`)."""
    if torch.is_grad_enabled() and x2.requires_grad:
        return _GatherRows.apply(x2, idx, channel_major)
    return _gather_rows(x2, idx, channel_major)


def scatter_rows_add(flat2: torch.Tensor, idx: torch.Tensor, y: torch.Tensor, channel_major: bool) -> torch.Tensor:
    """flat2 (n_rows, c)[idx[e, a]] += y's row of (e, a), y (E, c, n) with
    ``channel_major``, else (E, n, c), in place; returns flat2.  The CUDA
    kernel (atomic adds) for CUDA tensors, :func:`scatter_rows_add_plain`
    for CPU tensors.  idx must hold rows of flat2, unchecked on the card as
    in :func:`gather_rows`.  Differentiable with respect to flat2 and y (y's
    backward is :func:`gather_rows`)."""
    if torch.is_grad_enabled() and (flat2.requires_grad or y.requires_grad):
        return _ScatterRowsAdd.apply(flat2, idx, y, channel_major)
    _scatter_rows_add(flat2, idx, y, channel_major)
    return flat2


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, idx, channel_major):
        ctx.save_for_backward(idx)
        ctx.shape, ctx.channel_major = x2.shape, channel_major
        return _gather_rows(x2, idx, channel_major)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        gx = scatter_rows_add(g.new_zeros(ctx.shape), idx, g, ctx.channel_major)
        return gx, None, None


class _ScatterRowsAdd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, flat2, idx, y, channel_major):
        _scatter_rows_add(flat2, idx, y, channel_major)
        ctx.mark_dirty(flat2)
        ctx.save_for_backward(idx)
        ctx.channel_major = channel_major
        return flat2

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        gy = gather_rows(g, idx, ctx.channel_major) if ctx.needs_input_grad[2] else None
        return g, None, gy, None


def _gather_rows(x2: torch.Tensor, idx: torch.Tensor, channel_major: bool) -> torch.Tensor:
    if x2.device.type == "cpu":
        return gather_rows_plain(x2, idx, channel_major)
    _check(x2, idx, "gather_rows")
    E, n = idx.shape
    c = x2.shape[1]
    out = torch.empty((E, c, n) if channel_major else (E, n, c), dtype=x2.dtype, device=x2.device)
    srow, sunk = x2.stride()
    # a row's unknowns as one vector where they are contiguous and every row starts aligned
    vw = _vector_width(c, srow, x2 if channel_major else (x2, out), 16 // x2.element_size() if sunk == 1 else 1)
    dev, stream = device_and_stream(x2)
    fn = _library().rows_gather_f32 if x2.dtype == torch.float32 else _library().rows_gather_f64
    rc = fn(x2.data_ptr(), srow, sunk, idx.data_ptr(), out.data_ptr(), E * n, n, c, int(channel_major), vw, dev, stream)
    _done("gather", channel_major, rc)
    return out


def _scatter_rows_add(flat2: torch.Tensor, idx: torch.Tensor, y: torch.Tensor, channel_major: bool) -> None:
    if flat2.device.type == "cpu":
        return scatter_rows_add_plain(flat2, idx, y, channel_major)
    _check(flat2, idx, "scatter_rows_add")
    E, n = idx.shape
    c = flat2.shape[1]
    if y.device != flat2.device or y.dtype != flat2.dtype:
        raise ValueError("scatter_rows_add: y and the accumulator must share one device and dtype")
    if tuple(y.shape) != ((E, c, n) if channel_major else (E, n, c)):
        raise ValueError(f"scatter_rows_add: y {tuple(y.shape)} does not match idx {tuple(idx.shape)} and c = {c}")
    if not flat2.is_contiguous():
        raise ValueError("scatter_rows_add: the accumulator must be contiguous")
    y = y.contiguous()
    # vector atomics exist in float32 only; node-major y's rows are read as vectors too
    vw = _vector_width(c, c, flat2 if channel_major else (flat2, y), 4 if flat2.dtype == torch.float32 else 1)
    dev, stream = device_and_stream(flat2)
    fn = _library().rows_scatter_f32 if flat2.dtype == torch.float32 else _library().rows_scatter_f64
    rc = fn(y.data_ptr(), idx.data_ptr(), flat2.data_ptr(), E * n, n, c, int(channel_major), vw, dev, stream)
    _done("scatter", channel_major, rc)


def _vector_width(c: int, row_stride: int, tensors, most: int) -> int:
    """Values a row moves as one vector, at most ``most``: the widest of 4 and
    2 that divides c and the row stride and aligns every base of ``tensors``
    (one tensor or a tuple), else 1."""
    tensors = tensors if isinstance(tensors, tuple) else (tensors,)
    for vw in (4, 2):
        if vw <= most and c % vw == 0 and row_stride % vw == 0 and all(
            t.data_ptr() % (vw * t.element_size()) == 0 for t in tensors
        ):
            return vw
    return 1


def _check(t: torch.Tensor, idx: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {t.device}")
    if t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name} runs in float32 or float64, got {t.dtype}")
    if t.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"{name}: rows must be (n_rows, c) and idx (E, n), got {tuple(t.shape)}, {tuple(idx.shape)}")
    if idx.dtype != torch.int32 or idx.device != t.device or not idx.is_contiguous():
        raise ValueError(f"{name}: idx must be contiguous int32 on {t.device}")
    if idx.numel() * t.shape[1] >= 2**31:
        raise ValueError(f"{name}: the element block has 2^31 or more values")


def _done(op: str, channel_major: bool, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"row {op} kernel launch failed: CUDA error {rc}")
    launch_count[(op, _layout(channel_major))] += 1


def _declare(lib) -> None:
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in ("rows_gather_f32", "rows_gather_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, cl, cl, vp, vp] + [ci] * 6 + [vp]
        fn.restype = ci
    for name in ("rows_scatter_f32", "rows_scatter_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, vp] + [ci] * 6 + [vp]
        fn.restype = ci


def _library():
    return load("row_gather", _declare)
