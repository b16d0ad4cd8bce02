"""Per-QP least-squares algebra of the dense apply: a Hopper CUDA kernel and its plain version.

Port of the Pallas TPU kernel ``l3ster_tpu/ops/pallas_qp.py:qp_algebra_const_pallas``:
between the two basis matmuls of the dense-basis apply
(``algsys/local.py:local_apply_dense_const``) every quadrature point runs
``g_phys = J^-T g_ref``, ``r = A g``, ``w r``, ``t = A^T (w r)``,
``t_ref = J^-1 t`` with a constant A, in 2D or 3D.  Unlike the TPU kernel,
which works on (d1*c, EQ) lanes, this one reads and writes the matmuls' own
(E, c, d1, Q) layout (``csrc/qp_algebra.cu`` has the design note).

:func:`qp_algebra_const` is the dispatcher: on a CPU tensor it runs
:func:`qp_algebra_const_plain` (the torch ``_qp_algebra_const`` chain of
``algsys/local.py``); on a CUDA tensor it launches the kernel or raises.
``launch_count`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._cuda import SMEM_LIMIT, declare_coefficients, device_and_stream, load, upload_coefficients

__all__ = ["qp_algebra_const", "qp_algebra_const_plain"]

launch_count = 0  # kernel launches; read and reset by callers that check the path
# per device: the coefficient set last uploaded to the kernel's __constant__ memory
_uploaded: dict = {}


def qp_algebra_const_plain(A_const, G: torch.Tensor, Ji_t: torch.Tensor, w_t: torch.Tensor):
    """Plain torch version: T (E, c, d1, Q) from G (E, c, d1, Q), Ji_t (dim, dim, EQ)
    and w_t (EQ,), with EQ = E * Q in element-major order."""
    from ..algsys.local import _qp_algebra_const

    E, c, d1, Q = G.shape
    dim = d1 - 1
    vals_l = [G[:, u, 0].reshape(E * Q) for u in range(c)]
    rd = [[G[:, u, 1 + j].reshape(E * Q) for u in range(c)] for j in range(dim)]
    t0, tr = _qp_algebra_const(np.asarray(A_const, np.float64), Ji_t, w_t, vals_l, rd, dim, c, G.dtype)
    T = torch.stack([torch.stack(ch) for ch in [t0] + list(tr)])  # (d1, c, EQ)
    return T.reshape(d1, c, E, Q).permute(2, 1, 0, 3).contiguous()


def qp_algebra_const(A_const, G: torch.Tensor, Ji_t: torch.Tensor, w_t: torch.Tensor):
    """T (E, c, d1, Q) of the per-QP chain: the CUDA kernel for CUDA tensors,
    :func:`qp_algebra_const_plain` for CPU tensors."""
    if G.device.type == "cpu":
        return qp_algebra_const_plain(A_const, G, Ji_t, w_t)
    if G.device.type != "cuda":
        raise ValueError(f"qp_algebra_const runs on CPU or CUDA tensors, got {G.device}")
    return _launch(A_const, G, Ji_t, w_t)


def _declare(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    declare_coefficients(lib, "qp")
    for name in ("qp_f32", "qp_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [vp] * 4 + [ci] * 7 + [vp]
        fn.restype = ci
    lib.qp_threads.restype = ci


def _launch(A_const, G, Ji_t, w_t):
    global launch_count
    lib = load("qp_algebra", _declare)
    A = np.ascontiguousarray(A_const, dtype=np.float64)
    E, c, d1, Q = G.shape
    dim, EQ = d1 - 1, E * Q
    if dim not in (2, 3) or A.ndim != 3 or A.shape[0] != d1 or A.shape[2] != c:
        raise ValueError(f"A_const must be ({d1}, n_eq, {c}) with dim 2 or 3, got {A.shape}")
    if G.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"qp_algebra_const runs in float32 or float64, got {G.dtype}")
    for x in (Ji_t, w_t):
        if x.device != G.device or x.dtype != G.dtype:
            raise ValueError("qp_algebra_const inputs must share one device and dtype")
    if tuple(Ji_t.shape) != (dim, dim, EQ) or tuple(w_t.shape) != (EQ,):
        raise ValueError(
            f"qp_algebra_const: Ji_t {tuple(Ji_t.shape)} / w_t {tuple(w_t.shape)} do not match "
            f"E*Q = {EQ}, dim = {dim}"
        )
    if G.numel() >= 2**31:
        raise ValueError("qp_algebra_const: G has 2^31 or more values")
    n_eq = A.shape[1]
    smem = (d1 * c + n_eq) * lib.qp_threads() * G.element_size()
    if smem > SMEM_LIMIT:
        raise ValueError(f"qp_algebra_const needs {smem} bytes of shared memory; the limit is {SMEM_LIMIT}")
    G, Ji_t, w_t = G.contiguous(), Ji_t.contiguous(), w_t.contiguous()
    out = torch.empty_like(G)
    if EQ == 0:
        return out
    dev, stream = device_and_stream(G)
    upload_coefficients(lib, "qp", A, dev, stream, _uploaded)
    fn = lib.qp_f32 if G.dtype == torch.float32 else lib.qp_f64
    rc = fn(
        G.data_ptr(), Ji_t.data_ptr(), w_t.data_ptr(), out.data_ptr(),
        EQ, Q, c, dim, n_eq, smem, dev, stream,
    )
    if rc != 0:
        raise RuntimeError(f"qp_algebra kernel launch failed: CUDA error {rc}")
    launch_count += 1
    return out
