"""Fused sum-factorized local apply (constant A): a Hopper CUDA kernel and its plain version.

Port of the Pallas TPU kernel ``l3ster_tpu/ops/pallas_sumfact.py:sumfact_const_apply_pallas``:
one element per block runs the nodes -> QP sweeps, the per-QP algebra with a
constant A and the transpose sweeps, in 2D or 3D, with every intermediate in
shared memory (``csrc/sumfact_fused.cu`` has the design note): unrolled for
the orders in ``ORDERS``, run-time-sized for any other (:func:`launch_shape`).

:func:`sumfact_const_apply` is the dispatcher: on a CPU tensor it runs
:func:`sumfact_const_apply_plain` (``algsys/local.py:local_apply_sumfact_const``);
on a CUDA tensor it launches the kernel or raises.  It computes in the dtype
it is given (float32 or float64); ``LocalEvalStrategy.SUM_FACT_PALLAS`` hands
it float32, as the reference does.  ``launch_count`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ._cuda import (
    SMEM_LIMIT,
    coefficient_tables,
    declare_coefficients,
    device_and_stream,
    device_index,
    load,
    no_autograd,
    upload_coefficients,
)

__all__ = ["sumfact_const_apply", "sumfact_const_apply_plain"]

launch_count = 0  # kernel launches; read and reset by callers that check the path
# per device: the coefficient set last uploaded to the kernel's __constant__ memory
_uploaded: dict = {}


def sumfact_const_apply_plain(A_const, ji, w, order: int, q_order: int, dim: int, x_loc):
    """Plain torch version: y (E, n_nodes, c) from ji (E, Q, dim, dim), w (E, Q)
    and x_loc (E, n_nodes, c), in x_loc's dtype."""
    from ..algsys.local import local_apply_sumfact_const

    E, Q = w.shape
    Ji_t = ji.reshape(E * Q, dim, dim).permute(1, 2, 0)
    return local_apply_sumfact_const(A_const, Ji_t, w.reshape(-1), E, order, q_order, dim, x_loc)


def sumfact_const_apply(A_const, ji, w, order: int, q_order: int, dim: int, x_loc):
    """Fused local apply y (E, n_nodes, c): the CUDA kernel for CUDA tensors,
    :func:`sumfact_const_apply_plain` for CPU tensors."""
    if x_loc.device.type == "cpu":
        return sumfact_const_apply_plain(A_const, ji, w, order, q_order, dim, x_loc)
    if x_loc.device.type != "cuda":
        raise ValueError(f"sumfact_const_apply runs on CPU or CUDA tensors, got {x_loc.device}")
    return _launch(A_const, ji, w, order, q_order, dim, x_loc)


GROUP_THREADS, MAX_GROUPS = 64, 4  # csrc/sumfact_fused.cu: SF_TPC, SF_GROUPS
GENERIC_THREADS = 256  # csrc/sumfact_fused.cu: SF_GENERIC_THREADS
# the (n1, q1) pairs with an unrolled kernel: p = 1..6 at q1 = 2p and q1 = p + 1
ORDERS = tuple((p + 1, q) for p in range(1, 7) for q in sorted({2 * p, p + 1}))


def _generic_smem(n1: int, q1: int, dim: int, c: int, n_eq: int, itemsize: int) -> int:
    """Shared memory of one block (one element) of the run-time-sized kernel."""
    nb = n1 ** (dim - 1)
    vals = (
        2 * q1 * n1  # N1, D1
        + nb * n1 * c  # nodal tile
        + 2 * nb * q1 * c  # x stage
        + (3 * n1 * q1 * q1 * c if dim == 3 else 0)  # y stage of 3D
        + (dim + 1) * q1**dim * c  # QP tensors
        + n_eq * GENERIC_THREADS  # w * r of each thread's QP
    )
    return vals * itemsize


def launch_shape(order: int, q_order: int, dim: int, c: int, n_eq: int, n_ent: int, itemsize: int) -> dict:
    """The kernel's launch shape for one element per block and A's ``n_ent``
    nonzero entries.  Where (n1, q1) has an unrolled kernel and the element
    fits it: ``groups`` channel groups of 64 threads, whether J^-1 and w are
    ``staged`` in shared memory and the per-QP step takes a ``pair`` of QPs a
    thread (each where it fits), and ``smem`` bytes.  Else the run-time-sized
    kernel (``generic``, ``groups`` = 0).  Raises where one element fits
    neither."""
    n1, q1 = order + 1, q_order // 2 + 1
    Q = q1**dim
    groups = min(c, MAX_GROUPS)
    scratch = 3 * n1 * q1 * q1 if dim == 3 else 2 * q1 * n1  # a group's sweep scratch
    n_slot = (dim + 1) * c
    geo = Q * dim * dim + Q  # J^-1 and w of the element
    ints = (4 * n_ent + 2 * n_slot) * 4  # the flat records' offsets (const_coeffs.cuh: ca_stage_flat)
    # two QPs a thread in the per-QP step where their w * r fit, and J^-1 and w
    # staged where they fit; the element alone must fit
    for pair, staged in ((True, True), (True, False), (False, True), (False, False)):
        vals = n1**dim * c + c * (dim + 1) * Q + max(groups * scratch, (1 + pair) * n_eq * groups * GROUP_THREADS)
        vals += 2 * n_ent + n_slot + (geo if staged else 0)
        smem = vals * itemsize + ints
        if (n1, q1) in ORDERS and smem <= SMEM_LIMIT:
            return dict(generic=False, groups=groups, threads=groups * GROUP_THREADS, staged=staged, pair=pair, smem=smem)
    smem = _generic_smem(n1, q1, dim, c, n_eq, itemsize)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"sumfact_const_apply needs {smem} bytes of shared memory for one element "
            f"(order {order}, {Q} QPs, c = {c}); the limit is {SMEM_LIMIT}"
        )
    return dict(generic=True, groups=0, threads=GENERIC_THREADS, staged=False, pair=False, smem=smem)


@lru_cache(maxsize=16)
def _device_tables(order: int, q_order: int, dtype, device):
    """N1, D1 (q1, n1) on the card, for the run-time-sized kernel."""
    return tuple(torch.as_tensor(T, dtype=dtype, device=device).contiguous() for T in _host_tables(order, q_order))


@lru_cache(maxsize=16)
def _host_tables(order: int, q_order: int):
    from .sumfact import sumfact_tables_1d

    N1, D1, _ = sumfact_tables_1d(order, q_order)
    return np.ascontiguousarray(N1, np.float64), np.ascontiguousarray(D1, np.float64)


_tables_uploaded: dict = {}  # per device: the (order, q_order) of the tables in __constant__ memory


def _declare(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    declare_coefficients(lib, "sf")
    for name in ("sf_f32", "sf_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [vp] * 6 + [ci] * 11 + [vp]
        fn.restype = ci
    lib.sf_set_tables.argtypes = [vp, vp, ci, ci, ci, vp]
    lib.sf_set_tables.restype = ci
    lib.sf_occupancy.argtypes = [ci] * 8
    lib.sf_occupancy.restype = ci


def _library():
    return load("sumfact_fused", _declare)


def _launch(A_const, ji, w, order, q_order, dim, x_loc):
    global launch_count
    no_autograd("sumfact_fused", ji, w, x_loc)
    lib = _library()
    A = np.ascontiguousarray(A_const, dtype=np.float64)
    E, n_nodes, c = x_loc.shape
    n1, q1 = order + 1, q_order // 2 + 1
    Q = q1**dim
    if dim not in (2, 3) or n_nodes != n1**dim:
        raise ValueError(f"sumfact_const_apply: x_loc {tuple(x_loc.shape)} is not order {order} in 2D/3D")
    if A.ndim != 3 or A.shape[0] != dim + 1 or A.shape[2] != c:
        raise ValueError(f"A_const must be ({dim + 1}, n_eq, {c}), got {A.shape}")
    if x_loc.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"sumfact_const_apply runs in float32 or float64, got {x_loc.dtype}")
    for t in (ji, w):
        if t.device != x_loc.device or t.dtype != x_loc.dtype:
            raise ValueError("sumfact_const_apply inputs must share one device and dtype")
    if tuple(ji.shape) != (E, Q, dim, dim) or tuple(w.shape) != (E, Q):
        raise ValueError(
            f"sumfact_const_apply: ji {tuple(ji.shape)} / w {tuple(w.shape)} do not match "
            f"E = {E}, Q = {Q}, dim = {dim}"
        )
    n_eq, n_ent = A.shape[1], len(coefficient_tables(A)[3])
    sh = launch_shape(order, q_order, dim, c, n_eq, n_ent, x_loc.element_size())
    x_loc, ji, w = x_loc.contiguous(), ji.contiguous(), w.contiguous()
    y = torch.empty_like(x_loc)
    if E == 0:
        return y
    dev, stream = device_and_stream(x_loc)
    upload_coefficients(lib, "sf", A, dev, stream, _uploaded)
    tabs = (None, None)
    if sh["generic"]:
        tabs = tuple(t.data_ptr() for t in _device_tables(order, q_order, x_loc.dtype, x_loc.device))
    elif _tables_uploaded.get(dev) != (order, q_order):
        N1, D1 = _host_tables(order, q_order)
        rc = lib.sf_set_tables(N1.ctypes.data, D1.ctypes.data, q1, n1, dev, stream)
        if rc != 0:
            raise RuntimeError(f"sumfact_fused: table upload failed: CUDA error {rc}")
        _tables_uploaded[dev] = (order, q_order)
    fn = lib.sf_f32 if x_loc.dtype == torch.float32 else lib.sf_f64
    rc = fn(
        x_loc.data_ptr(), ji.data_ptr(), w.data_ptr(), *tabs, y.data_ptr(), E, c, dim, n1, q1, n_eq,
        sh["groups"], int(sh["staged"]), int(sh["pair"]), sh["smem"], dev, stream,
    )
    if rc != 0:
        raise RuntimeError(f"sumfact_fused kernel launch failed: CUDA error {rc}")
    launch_count += 1
    return y


def kernel_occupancy(dtype, A_const, order: int, q_order: int, dim: int, device=None) -> dict:
    """The launch shape on ``device`` (default: the current card), with the
    instantiation's resident blocks per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    A = np.ascontiguousarray(A_const, dtype=np.float64)
    itemsize = torch.empty((), dtype=dtype).element_size()
    sh = launch_shape(order, q_order, dim, A.shape[2], A.shape[1], len(coefficient_tables(A)[3]), itemsize)
    blocks = _library().sf_occupancy(
        int(dtype == torch.float64), int(sh["generic"]), dim, order + 1, q_order // 2 + 1, sh["threads"],
        sh["smem"], device_index(device),
    )
    if blocks < 0:
        raise RuntimeError(f"sumfact_fused occupancy query failed: CUDA error {-blocks}")
    return dict(sh, blocks_per_sm=blocks, warps_per_sm=blocks * sh["threads"] // 32)
