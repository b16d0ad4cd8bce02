"""Fused z-sweep of the lattice operator apply: a Hopper CUDA kernel and its plain version.

Port of the Pallas TPU kernel ``l3ster_tpu/ops/pallas_zsweep2.py:fused_z_sweep_v2``
in all its modes: constant A (baked into ``__constant__`` memory) or variable A
(the nonzero (d, i, u) planes ``A_nz`` (K, S, RQ) streamed from device memory),
diagonal or full geometry, and the ``layout="cz"`` (c, n1z, RQ) or ``"zc"``
(n1z, c, RQ) tensors.  Per column of the flattened (R, Q) QP plane it runs
the z interpolation of the post-y-stage tensors, the per-QP least-squares
algebra, and the z transpose, so no QP-space tensor reaches device memory
(``csrc/zsweep.cu`` has the design note).  ``ops/zsweep_v1.py`` serves the
reference's v1 kernel with the same CUDA kernel.

:func:`fused_z_sweep` is the dispatcher: on a CPU tensor it runs
:func:`fused_z_sweep_plain` (torch.einsum); on a CUDA tensor it launches the
kernel or raises.  The kernel is built with ``nvcc`` from the package's
sources at first use into ``l3ster_tpu_torch/_build/`` and bound with
``ctypes`` (``ops/_cuda.py``).  ``launch_count`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ._cuda import SMEM_LIMIT as _SMEM_LIMIT
from ._cuda import declare_coefficients, device_and_stream, load, upload_coefficients

__all__ = [
    "detect_diag_geometry",
    "ZSweepTables",
    "zsweep_tables",
    "plane_table",
    "fused_z_sweep",
    "fused_z_sweep_plain",
]

launch_count = 0  # kernel launches; read and reset by callers that check the path
# per device: the coefficient set last uploaded to the kernel's __constant__
# memory.  Uploads are ordered on the launching stream, so launches on one
# stream at a time per device see their own coefficients.
_uploaded: dict = {}


def detect_diag_geometry(Ji_l, w_l, S: int, tol: float = 1e-11):
    """Host-side check: is the packed geometry axis-aligned and separable?

    Ji_l (3, 3, EQ) and w_l (EQ,) in interleaved QP order (z-major:
    EQ = S * RQ).  Returns ("diag", jx (1,RQ), jy (1,RQ), jz (S,1),
    wyx (1,RQ), wz (S,1)) or None.  jx varies only along the lane (RQ) axis,
    jz only along S; w must factor as wz ⊗ wyx.
    """
    Ji = np.asarray(Ji_l)
    w = np.asarray(w_l)
    EQ = w.shape[0]
    if EQ % S:
        return None
    RQ = EQ // S
    J = Ji.reshape(3, 3, S, RQ)
    scale = np.abs(J).max() + 1e-300
    off = max(np.abs(J[i, j]).max() for i in range(3) for j in range(3) if i != j)
    if off > tol * scale:
        return None
    jxm, jym, jzm = J[0, 0], J[1, 1], J[2, 2]
    if np.abs(jxm - jxm[:1]).max() > tol * scale:
        return None
    if np.abs(jym - jym[:1]).max() > tol * scale:
        return None
    if np.abs(jzm - jzm[:, :1]).max() > tol * scale:
        return None
    wm = w.reshape(S, RQ)
    wz = wm[:, :1].copy()
    if np.abs(wz).min() <= 0:
        return None
    wyx = (wm[:1] / wz[0]).copy()
    if np.abs(wm - wz * wyx).max() > tol * np.abs(wm).max():
        return None
    return ("diag", jxm[:1].copy(), jym[:1].copy(), jzm[:, :1].copy(), wyx, wz)


@dataclass(frozen=True)
class ZSweepTables:
    """The banded z tables on the device, with the band limits the kernel visits."""

    NzT: torch.Tensor  # (n1z, S)
    DzT: torch.Tensor  # (n1z, S)
    band: torch.Tensor  # int32 (2S + 2n1z,): zlo[S], zhi[S], slo[n1z], shi[n1z]


def _band(nz: np.ndarray) -> np.ndarray:
    """(lo, hi): first and last True row of each column; (0, -1) for an empty column."""
    any_ = nz.any(axis=0)
    lo = np.where(any_, nz.argmax(axis=0), 0)
    hi = np.where(any_, nz.shape[0] - 1 - nz[::-1].argmax(axis=0), -1)
    return lo, hi


def zsweep_tables(NzT: np.ndarray, DzT: np.ndarray, dtype, device) -> ZSweepTables:
    """Device tables for :func:`fused_z_sweep` from host (n1z, S) tables."""
    nz = (np.asarray(NzT) != 0) | (np.asarray(DzT) != 0)
    zlo, zhi = _band(nz)
    slo, shi = _band(nz.T)
    band = np.concatenate([zlo, zhi, slo, shi]).astype(np.int32)
    return ZSweepTables(
        torch.as_tensor(np.asarray(NzT), dtype=dtype, device=device).contiguous(),
        torch.as_tensor(np.asarray(DzT), dtype=dtype, device=device).contiguous(),
        torch.as_tensor(band, device=device),
    )


def plane_table(nz_idx, n_eq: int, c: int) -> np.ndarray:
    """(4, n_eq, c) table of the variable mode: entry (d, i, u) holds k + 1 for
    the k-th nonzero plane ``nz_idx[k] == (d, i, u)`` and 0 elsewhere, so the
    packed coefficient tables of ``_cuda.coefficient_tables`` carry plane
    numbers where the constant mode carries values."""
    P = np.zeros((4, n_eq, c))
    for k, (d, i, u) in enumerate(nz_idx):
        if not (0 <= d < 4 and 0 <= i < n_eq and 0 <= u < c) or P[d, i, u]:
            raise ValueError(f"plane {k} = {(d, i, u)} is out of range or repeated")
        P[d, i, u] = k + 1
    return P


def _qp_algebra(A_const, var, g, w):
    """t (4, c, S, RQ) of the per-QP algebra on g (4, c, S, RQ), constant A
    (4, n_eq, c) or variable ``var = (nz_idx, A_nz (K, S, RQ), n_eq)``."""
    if var is None:
        A = torch.as_tensor(np.asarray(A_const, np.float64), dtype=g.dtype, device=g.device)
        r = torch.einsum("diu,dusq->isq", A, g) * w
        return torch.einsum("diu,isq->dusq", A, r)
    nz_idx, A_nz, n_eq = var
    c = g.shape[1]
    d, i, u = (torch.as_tensor([ix[j] for ix in nz_idx], device=g.device) for j in range(3))
    prod = A_nz * g[d, u]  # (K, S, RQ)
    r = torch.zeros((n_eq,) + prod.shape[1:], dtype=g.dtype, device=g.device).index_add_(0, i, prod) * w
    t = torch.zeros((4 * c,) + prod.shape[1:], dtype=g.dtype, device=g.device)
    return t.index_add_(0, d * c + u, A_nz * r[i]).reshape((4, c) + prod.shape[1:])


def fused_z_sweep_plain(A_const, b, bdy, bdx, geom: tuple, NzT, DzT, var=None, layout: str = "cz"):
    """Plain torch version of the fused z-sweep; returns (a, ady, adx).

    A_const (4, n_eq, c) numpy, or None with ``var = (nz_idx, A_nz (K, S, RQ),
    n_eq)``: the nonzero (d, i, u) planes of a variable A; b, bdy, bdx
    (c, n1z, RQ), or (n1z, c, RQ) with ``layout="zc"``; NzT, DzT (n1z, S)
    tensors; geom ("diag", jx (1,RQ), jy (1,RQ), jz (S,1), wyx (1,RQ),
    wz (S,1)) or ("full", ji (9,S,RQ), w (S,RQ)) with ji plane j*3+i = Ji[j, i].
    """
    if layout == "zc":
        b, bdy, bdx = (x.transpose(0, 1) for x in (b, bdy, bdx))
    elif layout != "cz":
        raise ValueError(f"unknown layout {layout!r}")
    v = torch.einsum("czq,zs->csq", b, NzT)
    dz = torch.einsum("czq,zs->csq", b, DzT)
    dy = torch.einsum("czq,zs->csq", bdy, NzT)
    dx = torch.einsum("czq,zs->csq", bdx, NzT)
    if geom[0] == "diag":
        _, jx, jy, jz, wyx, wz = geom
        g = torch.stack([v, jx * dx, jy * dy, jz * dz])
        w = wz * wyx
    else:
        _, ji, w = geom
        rd = (dx, dy, dz)
        g = torch.stack([v] + [sum(ji[j * 3 + i] * rd[j] for j in range(3)) for i in range(3)])
    t = _qp_algebra(A_const, var, g, w)
    if geom[0] == "diag":
        tx, ty, tz = jx * t[1], jy * t[2], jz * t[3]
    else:
        tx, ty, tz = (sum(ji[j * 3 + i] * t[1 + i] for i in range(3)) for j in range(3))
    a = torch.einsum("csq,zs->czq", t[0], NzT) + torch.einsum("csq,zs->czq", tz, DzT)
    ady = torch.einsum("csq,zs->czq", ty, NzT)
    adx = torch.einsum("csq,zs->czq", tx, NzT)
    if layout == "zc":
        return tuple(x.transpose(0, 1).contiguous() for x in (a, ady, adx))
    return a, ady, adx


def fused_z_sweep(A_const, b, bdy, bdx, geom: tuple, tabs: ZSweepTables, var=None, layout: str = "cz"):
    """(a, ady, adx) of the fused z-sweep: the CUDA kernel for CUDA tensors,
    :func:`fused_z_sweep_plain` for CPU tensors."""
    global launch_count
    if b.device.type == "cpu":
        return fused_z_sweep_plain(A_const, b, bdy, bdx, geom, tabs.NzT, tabs.DzT, var, layout)
    out = launch(A_const, b, bdy, bdx, geom, tabs, var, layout)
    launch_count += 1
    return out


# ---------------------------------------------------------------------- build


def _declare(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    declare_coefficients(lib, "zsweep")
    for name in ("zsweep_f32", "zsweep_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [vp] * 15 + [ci] * 12 + [vp]
        fn.restype = ci


def _library():
    return load("zsweep", _declare)


def _tile_columns(c: int, n1z: int, S: int, itemsize: int) -> tuple[int, int]:
    """(TQ, shared bytes): the widest column tile whose shared memory fits.
    A variable A is read from device memory, so it takes no shared memory."""
    for tq in (32, 16, 8, 4, 2, 1):
        smem = (2 * n1z * S + 8 * c * S * tq) * itemsize + (2 * S + 2 * n1z) * 4
        if smem <= _SMEM_LIMIT:
            return tq, smem
    raise ValueError(
        f"fused z-sweep needs {smem} bytes of shared memory for one column "
        f"(c={c}, n1z={n1z}, S={S}); the limit is {_SMEM_LIMIT}"
    )


def launch(A_const, b, bdy, bdx, geom, tabs: ZSweepTables, var=None, layout: str = "cz"):
    """Launch the CUDA kernel on CUDA tensors (no launch count: each public
    wrapper counts its own launches); raises on what the kernel does not take."""
    if b.device.type != "cuda":
        raise ValueError(f"the z-sweep kernel runs on CUDA tensors, got {b.device}")
    lib = _library()
    if layout == "cz":
        c, n1z, RQ = b.shape
        cs, zs = n1z * RQ, RQ
    elif layout == "zc":
        n1z, c, RQ = b.shape
        cs, zs = RQ, c * RQ
    else:
        raise ValueError(f"unknown layout {layout!r}")
    S = tabs.NzT.shape[1]
    if var is None:
        A = np.ascontiguousarray(A_const, dtype=np.float64)
        if A.ndim != 3 or A.shape[0] != 4 or A.shape[2] != c:
            raise ValueError(f"A_const must be (4, n_eq, {c}), got {A.shape}")
        Anz = None
    else:
        if A_const is not None:
            raise ValueError("give either a constant A or var, not both")
        nz_idx, Anz, n_eq_v = var
        A = plane_table(nz_idx, n_eq_v, c)
        if tuple(Anz.shape) != (len(nz_idx), S, RQ):
            raise ValueError(f"A_nz must be ({len(nz_idx)}, {S}, {RQ}), got {tuple(Anz.shape)}")
    if b.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fused z-sweep runs in float32 or float64, got {b.dtype}")
    diag = geom[0] == "diag"
    if diag:
        _, jx, jy, jz, wyx, wz = geom
        g = [jx, jy, jz, wyx, wz]
        sizes = [RQ, RQ, S, RQ, S]
    else:
        _, ji, w = geom
        g = [ji, w]
        sizes = [9 * S * RQ, S * RQ]
    ins = [b, bdy, bdx, tabs.NzT, tabs.DzT] + g + ([] if Anz is None else [Anz])
    for x in ins:
        if x.device != b.device or x.dtype != b.dtype:
            raise ValueError("fused z-sweep inputs must share one device and dtype")
    if bdy.shape != b.shape or bdx.shape != b.shape or tuple(tabs.NzT.shape) != (n1z, S):
        raise ValueError("fused z-sweep: inconsistent b / bdy / bdx / table shapes")
    for x, n in zip(g, sizes):
        if x.numel() != n:
            raise ValueError(f"fused z-sweep: geometry tensor of {x.numel()} values, expected {n}")
    n_eq = A.shape[1]
    tq, smem = _tile_columns(c, n1z, S, b.element_size())
    b, bdy, bdx = b.contiguous(), bdy.contiguous(), bdx.contiguous()
    g = [x.contiguous() for x in g] + [None] * (5 - len(g))
    Anz = None if Anz is None else Anz.contiguous()
    a, ady, adx = (torch.empty_like(b) for _ in range(3))
    dev, stream = device_and_stream(b)
    upload_coefficients(lib, "zsweep", A, dev, stream, _uploaded)
    fn = lib.zsweep_f32 if b.dtype == torch.float32 else lib.zsweep_f64
    ptr = [None if x is None else x.data_ptr() for x in [b, bdy, bdx] + g + [Anz]]
    rc = fn(
        *ptr, tabs.NzT.data_ptr(), tabs.DzT.data_ptr(), tabs.band.data_ptr(),
        a.data_ptr(), ady.data_ptr(), adx.data_ptr(),
        c, n1z, S, RQ, n_eq, int(diag), int(var is not None), tq, smem, cs, zs, dev, stream,
    )
    if rc != 0:
        raise RuntimeError(f"z-sweep kernel launch failed: CUDA error {rc}")
    return a, ady, adx
