"""x/y sweep-stage matmuls of the lattice apply: a Hopper CUDA kernel and its plain version.

Counterpart of the Pallas TPU kernels of ``l3ster_tpu/ops/pallas_stages.py``:
:func:`kstacked_matmul` computes one banded sweep stage ``x @ T`` or the
K-concat pair ``x @ T[:K1] + x2 @ T[K1:]``, and :func:`stage_tables` /
:func:`kc_transpose_tables` build the exact tables the reference builds with
``split=False``.  The reference's bf16x3 ``[Th; Th; Tl]`` stacking
(``_tstack3``) and its VMEM row-block sizing (``_pick_mb``) serve the TPU's
matrix unit and are not ported: the kernel computes in full f32 or f64.

:func:`kstacked_matmul` is the dispatcher: on a CPU tensor it runs
:func:`kstacked_matmul_plain` (``x @ T1 (+ x2 @ T2)``); on a CUDA tensor it
launches ``csrc/stage_matmul.cu`` (a tiled GEMM with its tiles in shared
memory) or raises.  ``launch_count`` counts kernel launches.  The stages run
in the lattice apply under ``L3STER_TPU_XY_PALLAS=1``
(``ops/lattice_sumfact.py``).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ._cuda import device_and_stream, load

__all__ = [
    "stage_tables",
    "kc_transpose_tables",
    "device_table",
    "kstacked_matmul",
    "kstacked_matmul_plain",
]

launch_count = 0  # kernel launches; read and reset by callers that check the path


@lru_cache(maxsize=None)
def stage_tables(order: int, q_order: int, ne_a: int, kind: str) -> np.ndarray:
    """Host table (float64) for one sweep stage of axis size ``ne_a``.

    kind: "ND"  -> [N | D] paired interpolation table, (n1, 2*Qa)
          "N"   -> N only, (n1, Qa)
          "NDT" -> transpose-pair table [[N'], [D']], (2*Qa, n1), consumed
                   with the K-concat input [a | ad]
          "NT"  -> N' only, (Qa, n1)
    """
    from .lattice_sumfact import banded_tables

    Ng, Dg = banded_tables(order, q_order, ne_a)  # (Qa, n1)
    if kind == "ND":
        return np.concatenate([Ng.T, Dg.T], axis=1)
    if kind == "N":
        return Ng.T.copy()
    if kind == "NDT":
        return np.concatenate([Ng, Dg], axis=0)
    if kind == "NT":
        return Ng.copy()
    raise ValueError(f"unknown stage table kind {kind!r}")


def kc_transpose_tables(order: int, q_order: int, ne_a: int) -> np.ndarray:
    """K-concat transpose-pair table for ``a @ N' + ad @ D'``: (2*Qa, n1)."""
    return stage_tables(order, q_order, ne_a, "NDT")


@lru_cache(maxsize=None)
def device_table(order: int, q_order: int, ne_a: int, kind: str, dtype, device) -> torch.Tensor:
    """:func:`stage_tables` on the device, cached: each apply reuses one copy."""
    return torch.as_tensor(stage_tables(order, q_order, ne_a, kind), dtype=dtype, device=device)


def kstacked_matmul_plain(x: torch.Tensor, x2: torch.Tensor | None, T: torch.Tensor, N: int) -> torch.Tensor:
    """Plain torch version: ``x @ T[:K1] (+ x2 @ T[K1:])``, (M, N)."""
    K1 = x.shape[1]
    out = x @ T[:K1]
    return out if x2 is None else out + x2 @ T[K1:]


def kstacked_matmul(x: torch.Tensor, x2: torch.Tensor | None, T: torch.Tensor, N: int) -> torch.Tensor:
    """One sweep stage, (M, N): the CUDA kernel for CUDA tensors,
    :func:`kstacked_matmul_plain` for CPU tensors.

    x (M, K1); x2 (M, K2) or None; T (K1 [+ K2], N) from :func:`stage_tables`."""
    global launch_count
    K = x.shape[1] + (0 if x2 is None else x2.shape[1])
    if T.dim() != 2 or tuple(T.shape) != (K, N):
        raise ValueError(f"stage table must be ({K}, {N}), got {tuple(T.shape)}")
    if x.device.type == "cpu":
        return kstacked_matmul_plain(x, x2, T, N)
    out = _launch(x, x2, T, N)
    launch_count += 1
    return out


# ---------------------------------------------------------------------- build


def _declare(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name in ("stage_matmul_f32", "stage_matmul_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [vp] * 4 + [ci] * 5 + [vp]
        fn.restype = ci


def _library():
    return load("stage_matmul", _declare)


def _launch(x, x2, T, N):
    if x.device.type != "cuda":
        raise ValueError(f"the stage kernel runs on CUDA tensors, got {x.device}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the stage kernel runs in float32 or float64, got {x.dtype}")
    ins = [x, T] + ([] if x2 is None else [x2])
    for t in ins:
        if t.device != x.device or t.dtype != x.dtype or t.dim() != 2:
            raise ValueError("stage kernel inputs must be 2D and share one device and dtype")
    M, K1 = x.shape
    K2 = 0 if x2 is None else x2.shape[1]
    if x2 is not None and x2.shape[0] != M:
        raise ValueError(f"x2 has {x2.shape[0]} rows, x has {M}")
    lib = _library()
    x, T = x.contiguous(), T.contiguous()
    x2 = None if x2 is None else x2.contiguous()
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    dev, stream = device_and_stream(x)
    fn = lib.stage_matmul_f32 if x.dtype == torch.float32 else lib.stage_matmul_f64
    rc = fn(
        x.data_ptr(), None if x2 is None else x2.data_ptr(), T.data_ptr(), out.data_ptr(),
        M, K1, K2, N, dev, stream,
    )
    if rc != 0:
        raise RuntimeError(f"stage kernel launch failed: CUDA error {rc}")
    return out
