"""Fused sum-factorized local apply (constant A): a Hopper CUDA kernel and its plain version.

Port of the Pallas TPU kernel ``l3ster_tpu/ops/pallas_sumfact.py:sumfact_const_apply_pallas``:
one element per block runs the nodes -> QP sweeps, the per-QP algebra with a
constant A and the transpose sweeps, in 2D or 3D, with every intermediate in
shared memory (``csrc/sumfact_fused.cu`` has the design note).

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

from ._cuda import SMEM_LIMIT, declare_coefficients, device_and_stream, load, upload_coefficients

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


def _smem_bytes(order: int, q_order: int, dim: int, c: int, n_eq: int, itemsize: int, threads: int) -> int:
    """Shared memory one block (one element) of the kernel takes."""
    n1, q1 = order + 1, q_order // 2 + 1
    nb = n1 ** (dim - 1)
    vals = (
        2 * q1 * n1  # N1, D1
        + nb * n1 * c  # nodal tile
        + 2 * nb * q1 * c  # x stage
        + (3 * n1 * q1 * q1 * c if dim == 3 else 0)  # y stage of 3D
        + (dim + 1) * q1**dim * c  # QP tensors
        + n_eq * threads  # r of each thread's QP
    )
    return vals * itemsize


@lru_cache(maxsize=16)
def _device_tables(order: int, q_order: int, dtype, device):
    from .sumfact import sumfact_tables_1d

    N1, D1, _ = sumfact_tables_1d(order, q_order)
    return tuple(torch.as_tensor(T, dtype=dtype, device=device).contiguous() for T in (N1, D1))


def _declare(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    declare_coefficients(lib, "sf")
    for name in ("sf_f32", "sf_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [vp] * 6 + [ci] * 8 + [vp]
        fn.restype = ci
    lib.sf_threads.restype = ci


def _launch(A_const, ji, w, order, q_order, dim, x_loc):
    global launch_count
    lib = load("sumfact_fused", _declare)
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
    n_eq = A.shape[1]
    smem = _smem_bytes(order, q_order, dim, c, n_eq, x_loc.element_size(), lib.sf_threads())
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"sumfact_const_apply needs {smem} bytes of shared memory for one element "
            f"(order {order}, {Q} QPs, c = {c}); the limit is {SMEM_LIMIT}"
        )
    tabs = _device_tables(order, q_order, x_loc.dtype, x_loc.device)
    x_loc, ji, w = x_loc.contiguous(), ji.contiguous(), w.contiguous()
    y = torch.empty_like(x_loc)
    if E == 0:
        return y
    dev, stream = device_and_stream(x_loc)
    upload_coefficients(lib, "sf", A, dev, stream, _uploaded)
    fn = lib.sf_f32 if x_loc.dtype == torch.float32 else lib.sf_f64
    rc = fn(
        x_loc.data_ptr(), ji.data_ptr(), w.data_ptr(), tabs[0].data_ptr(), tabs[1].data_ptr(),
        y.data_ptr(), E, n1, q1, c, dim, n_eq, smem, dev, stream,
    )
    if rc != 0:
        raise RuntimeError(f"sumfact_fused kernel launch failed: CUDA error {rc}")
    launch_count += 1
    return y
