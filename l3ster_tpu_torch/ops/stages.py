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
launches ``csrc/stage_matmul.cu`` or raises.  The kernel walks only each
output column's band of nonzero table rows, which :func:`band_descriptor`
reads from the table once (:func:`device_table` caches it beside the
table), and takes its launch shape from :func:`launch_shape`.
``launch_count`` counts kernel launches.  The stages run in the lattice
apply under ``L3STER_TPU_XY_PALLAS=1`` (``ops/lattice_sumfact.py``).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ._cuda import SMEM_LIMIT, device_and_stream, load

__all__ = [
    "StageBand",
    "stage_tables",
    "kc_transpose_tables",
    "band_descriptor",
    "device_table",
    "launch_shape",
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


class StageBand(NamedTuple):
    """The band of a stage table T (K, N) split at row ``k1`` into two K halves.

    ``desc`` (N, 4) int32, on the kernel's device: per output column n, the
    first nonzero row and the row count of its band in each half, as
    (first1, count1, first2, count2), rows counted from the half's start (a
    column with no nonzero in a half has count 0).  ``span``: per half, the
    most rows the union of the bands of a group of 4 consecutive columns
    (0-3, 4-7, ...) covers, widened to whole 16-byte vectors of x where
    both halves are (:func:`_vec_width`).  ``values`` (ceil(N / 4),
    span1 + span2, 4), in the kernel's dtype: per column group, T's rows in
    that union for each half (zero past its end), with each column's values
    outside its own band zero; the kernel reads T through it.  ``table``:
    the tensor T these were built from, the one table a call with this band
    may pass (:func:`kstacked_matmul` checks it)."""

    desc: torch.Tensor
    span: tuple
    k1: int
    values: torch.Tensor
    table: torch.Tensor

    def built_from(self, T: torch.Tensor) -> bool:
        """Whether T is this band's table (the same storage, shape and
        strides: a check that reads no values)."""
        t = self.table
        return (T.data_ptr(), T.shape, T.stride(), T.dtype, T.device) == (
            t.data_ptr(), t.shape, t.stride(), t.dtype, t.device
        )


def band_descriptor(T, k1: int, device=None, dtype=None) -> StageBand:
    """The :class:`StageBand` of T (a numpy array or a tensor; a tensor is
    read back to the host) with halves ``[0, k1)`` and ``[k1, K)``, on
    ``device`` (default: T's) with values in ``dtype`` (default: T's).  Its
    ``table`` is T itself where T is a tensor on that device in that dtype,
    else T copied there."""
    table = T if isinstance(T, torch.Tensor) else None
    if table is not None:
        device = T.device if device is None else device
        dtype = T.dtype if dtype is None else dtype
        T = T.detach().cpu().numpy()
    Th = np.asarray(T, dtype=np.float64)
    K, N = Th.shape
    if not 0 < k1 <= K:
        raise ValueError(f"band split k1={k1} outside (0, {K}]")
    dtype = torch.float64 if dtype is None else dtype
    align = _vec_width(k1, K - k1, torch.empty((), dtype=dtype).element_size())
    ncg = -(-N // 4)
    desc = np.zeros((ncg * 4, 4), np.int32)  # padded to whole groups with empty columns
    span, packed = [], []
    for h, (lo, hi) in enumerate(((0, k1), (k1, K))):
        if hi == lo:  # a single table: no second half
            span.append(0)
            continue
        nz = Th[lo:hi] != 0  # NaN counts as nonzero
        has = nz.any(axis=0)
        first = np.where(has, nz.argmax(axis=0), 0)
        last = hi - lo - 1 - nz[::-1].argmax(axis=0)
        desc[:N, 2 * h] = first
        desc[:N, 2 * h + 1] = np.where(has, last - first + 1, 0)
        f, cnt = desc[:, 2 * h], desc[:, 2 * h + 1]
        g_end = -(-(f + cnt).reshape(ncg, 4).max(axis=1) // align) * align  # the kernel's group_rows
        kb = np.where(g_end > 0, np.where(cnt > 0, f, K).reshape(ncg, 4).min(axis=1) // align * align, 0)
        span.append(int((g_end - kb).max()))
        r = kb[:, None, None] + np.arange(span[h])[None, :, None]  # (group, row, column) rows of the half
        n = (4 * np.arange(ncg)[:, None] + np.arange(4))[:, None, :]
        ok = (r >= f[n]) & (r < f[n] + cnt[n])
        packed.append(np.where(ok, Th[lo + np.minimum(r, hi - lo - 1), np.minimum(n, N - 1)], 0.0))
    values = np.concatenate(packed, axis=1) if packed else np.zeros((ncg, 0, 4))
    device = "cpu" if device is None else device
    table = torch.as_tensor(Th if table is None else table, dtype=dtype, device=device)
    return StageBand(
        torch.as_tensor(desc[:N], device=device), tuple(span), int(k1),
        torch.as_tensor(values, dtype=dtype, device=device), table,
    )


@lru_cache(maxsize=None)
def device_table(order: int, q_order: int, ne_a: int, kind: str, dtype, device) -> tuple:
    """(:func:`stage_tables` on the device, its :class:`StageBand`), cached:
    each apply reuses one copy of both, and no apply reads a table back."""
    T = stage_tables(order, q_order, ne_a, kind)
    band = band_descriptor(T, T.shape[0] // 2 if kind == "NDT" else T.shape[0], device, dtype)
    return band.table, band


def kstacked_matmul_plain(x: torch.Tensor, x2: torch.Tensor | None, T: torch.Tensor, N: int) -> torch.Tensor:
    """Plain torch version: ``x @ T[:K1] (+ x2 @ T[K1:])``, (M, N)."""
    K1 = x.shape[1]
    out = x @ T[:K1]
    return out if x2 is None else out + x2 @ T[K1:]


def kstacked_matmul(
    x: torch.Tensor, x2: torch.Tensor | None, T: torch.Tensor, N: int, band: StageBand | None = None
) -> torch.Tensor:
    """One sweep stage, (M, N): the CUDA kernel for CUDA tensors,
    :func:`kstacked_matmul_plain` for CPU tensors.

    x (M, K1); x2 (M, K2) or None; T (K1 [+ K2], N) from :func:`stage_tables`;
    band: T's :class:`StageBand` split at K1 in x's dtype (from
    :func:`device_table`), or None to build it from T here (a read of T back
    to the host).  The kernel reads T through the band's values, so a band
    built from another tensor than T raises."""
    global launch_count
    K = x.shape[1] + (0 if x2 is None else x2.shape[1])
    if T.dim() != 2 or tuple(T.shape) != (K, N):
        raise ValueError(f"stage table must be ({K}, {N}), got {tuple(T.shape)}")
    if band is not None and not band.built_from(T):
        raise ValueError("the stage band was built from another table than T")
    if x.device.type == "cpu":
        return kstacked_matmul_plain(x, x2, T, N)
    if band is None:
        band = band_descriptor(T, x.shape[1])
    out = _launch(x, x2, T, N, band)
    launch_count += 1
    return out


# ---------------------------------------------------------------------- build

# slabs (one block each) wanted per SM before rows per thread are traded for
# more slabs: a bench stage runs best as one wave of blocks, and more rows a
# thread share each band load
_SLABS_PER_SM = 0.7
_MAX_THREADS = 256  # csrc/stage_matmul.cu: SB_MAX_THREADS


def _round16(n: int, itemsize: int) -> int:
    v = 16 // itemsize
    return -(-n // v) * v


def _vec_width(K1: int, K2: int, itemsize: int) -> int:
    """Band rows the kernel takes at once: a 16-byte vector of x where both K
    halves are whole vectors (its padded-row path), else 1."""
    v = 16 // itemsize
    return v if K1 % v == 0 and K2 % v == 0 else 1


def _padded_row(k: int, itemsize: int) -> int:  # csrc/stage_matmul.cu: padded_row
    v = 16 // itemsize
    kp = _round16(k, itemsize)
    return kp if (kp // v) % 2 else kp + v


def _shape(M, N, K1, K2, span, itemsize, rm, rgs) -> dict:
    """The launch shape of ``rm`` rows a thread and ``rgs`` row groups a slab."""
    ncg = -(-N // 4)
    v = 16 // itemsize
    vec = _vec_width(K1, K2, itemsize) > 1
    bm = rgs * rm
    if vec:
        xvals = bm * (_padded_row(K1, itemsize) + (_padded_row(K2, itemsize) if K2 else 0))
    else:
        xvals = _round16(bm * K1 + v, itemsize) + (_round16(bm * K2 + v, itemsize) if K2 else 0)
    threads = min(_MAX_THREADS, -(-rgs * ncg // 32) * 32)
    tile = _round16(bm * N + v, itemsize) if N % 4 else 0  # a slab's outputs, staged for 16-byte stores
    smem = itemsize * (xvals + tile + ncg * (span[0] + span[1]) * 4) + 16 * N  # + the descriptor
    return dict(rm=rm, vec=int(vec), rgs=rgs, threads=threads, slabs=-(-M // bm), smem=smem)


@lru_cache(maxsize=256)
def launch_shape(M: int, N: int, K1: int, K2: int, span: tuple, itemsize: int, n_sm: int) -> dict:
    """The kernel's launch shape: ``rm`` rows of x per thread, ``rgs`` row
    groups per slab (``rgs * rm`` rows), ``threads`` (about 256) per block
    over a slab's ``rgs * ceil(N / 4)`` (row group, column group) items,
    ``vec`` for the padded-row path, ``slabs`` (one block each), and
    ``smem`` bytes of shared memory (the packed bands, the descriptor, a
    slab's outputs where N % 4 != 0, and the slab).  Takes the most rows per
    thread that still gives ``_SLABS_PER_SM`` slabs per SM of the ``n_sm``
    and fits."""
    ncg = -(-N // 4)
    rgs = max(1, _MAX_THREADS // ncg)
    if _vec_width(K1, K2, itemsize) > 1:  # whole quarter-warps of consecutive rows
        rgs = max(8, rgs // 8 * 8)
    fits = []
    for rm in (8, 4, 2, 1):
        sh = _shape(M, N, K1, K2, span, itemsize, rm, rgs)
        if sh["smem"] <= SMEM_LIMIT:
            if sh["slabs"] >= _SLABS_PER_SM * n_sm:
                return sh
            fits.append(sh)
    if not fits:
        raise ValueError(
            f"stage kernel: a slab row of K = {K1} + {K2} and bands of {span} rows for N = {N} "
            f"do not fit {SMEM_LIMIT} bytes of shared memory"
        )
    return fits[-1]  # the most slabs


@lru_cache(maxsize=None)
def _sm_count(dev: int) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _declare(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name in ("stage_band_f32", "stage_band_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [vp] * 5 + [ci] * 12 + [vp]
        fn.restype = ci
    lib.stage_band_occupancy.argtypes = [ci] * 6
    lib.stage_band_occupancy.restype = ci


def _library():
    return load("stage_matmul", _declare)


def _launch(x, x2, T, N, band: StageBand):
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
    desc, vals = band.desc, band.values
    for t, shape, dt in ((desc, (N, 4), torch.int32), (vals, (-(-N // 4), sum(band.span), 4), x.dtype)):
        if tuple(t.shape) != shape or t.dtype != dt or t.device != x.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("the stage band must be this table's, in the inputs' dtype and on their device")
    if band.k1 != K1:
        raise ValueError(f"the stage band is split at row {band.k1}, x has {K1} columns")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    dev, stream = device_and_stream(x)
    sh = launch_shape(M, N, K1, K2, band.span, x.element_size(), _sm_count(dev))
    lib = _library()
    x = x.contiguous()
    x2 = None if x2 is None else x2.contiguous()
    fn = lib.stage_band_f32 if x.dtype == torch.float32 else lib.stage_band_f64
    rc = fn(
        x.data_ptr(), None if x2 is None else x2.data_ptr(), vals.data_ptr(), desc.data_ptr(), out.data_ptr(),
        M, K1, K2, N, *band.span, *(sh[k] for k in ("rm", "vec", "rgs", "threads", "smem")), dev, stream,
    )
    if rc != 0:
        raise RuntimeError(f"stage kernel launch failed: CUDA error {rc}")
    return out


def kernel_occupancy(dtype, M: int, K1: int, K2: int, band: StageBand) -> dict:
    """The launch shape of a stage on the current card, with the kernel
    instantiation's resident blocks per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    dev = torch.cuda.current_device()
    itemsize = torch.empty((), dtype=dtype).element_size()
    sh = launch_shape(M, band.desc.shape[0], K1, K2, band.span, itemsize, _sm_count(dev))
    blocks = _library().stage_band_occupancy(
        int(dtype == torch.float64), sh["rm"], sh["vec"], sh["threads"], sh["smem"], dev
    )
    if blocks < 0:
        raise RuntimeError(f"stage kernel occupancy query failed: CUDA error {-blocks}")
    return dict(sh, blocks_per_sm=blocks, warps_per_sm=blocks * sh["threads"] // 32)
