"""Fused z-sweep of the lattice operator apply: a Hopper CUDA kernel and its plain version.

Port of the Pallas TPU kernel ``l3ster_tpu/ops/pallas_zsweep2.py:fused_z_sweep_v2``
in all its modes: constant A (baked into ``__constant__`` memory) or variable A
(the nonzero (d, i, u) planes ``A_nz`` (K, S, RQ) streamed from device memory),
diagonal or full geometry, and the ``layout="cz"`` (c, n1z, RQ) or ``"zc"``
(n1z, c, RQ) tensors.  Per column of the flattened (R, Q) QP plane it runs
the z interpolation of the post-y-stage tensors, the per-QP least-squares
algebra, and the z transpose, so no QP-space tensor reaches device memory
(``csrc/zsweep.cu`` has the design note).  The kernel takes the z tables
by element layer (:func:`zsweep_layers`) and its launch shape from
:func:`launch_shape`.  ``ops/zsweep_v1.py`` serves the reference's v1
kernel with the same CUDA kernel.

:func:`fused_z_sweep` is the dispatcher: on a CPU tensor it runs
:func:`fused_z_sweep_plain` (torch.einsum); on a CUDA tensor it launches the
kernel or raises.  The kernel is built with ``nvcc`` from the package's
sources at first use into ``l3ster_tpu_torch/_build/`` and bound with
``ctypes`` (``ops/_cuda.py``).  ``launch_count`` counts kernel launches,
``launches_by_device`` the same launches by device index.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ._cuda import SMEM_LIMIT as _SMEM_LIMIT
from ._cuda import (
    coefficient_tables,
    count_launch,
    declare_coefficients,
    device_and_stream,
    device_index,
    load,
    no_autograd,
    upload_coefficients,
)

__all__ = [
    "detect_diag_geometry",
    "ZSweepTables",
    "zsweep_layers",
    "zsweep_tables",
    "launch_shape",
    "plane_table",
    "fused_z_sweep",
    "fused_z_sweep_plain",
]

launch_count = 0  # kernel launches; read and reset by callers that check the path
launches_by_device: dict = {}  # the same launches by CUDA device index
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
    """The banded z tables: dense on the device for the plain version, and
    compact, by element layer, for the kernel (:func:`zsweep_layers`)."""

    NzT: torch.Tensor  # (n1z, S)
    DzT: torch.Tensor  # (n1z, S)
    layers: np.ndarray  # int32 (nL, 4) on the host: s0, nq, z0, nn of each layer
    lay: torch.Tensor  # the same on the device
    blk: torch.Tensor  # (2, nL, WQ, WN): each layer's (nq, nn) N block, then D block
    dims: tuple  # (nL, WQ, WN): layers, and the most QP rows and node rows of one


def _band(nz: np.ndarray) -> np.ndarray:
    """(lo, hi): first and last True row of each column; (0, -1) for an empty column."""
    any_ = nz.any(axis=0)
    lo = np.where(any_, nz.argmax(axis=0), 0)
    hi = np.where(any_, nz.shape[0] - 1 - nz[::-1].argmax(axis=0), -1)
    return lo, hi


def zsweep_layers(NzT: np.ndarray, DzT: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The element-layer form of (n1z, S) z tables: (layers, blk).

    A lattice z table is a run of layers, each a block of nq consecutive
    columns (QP rows) whose nonzeros lie in nn consecutive node rows, the
    first node row of each layer being the last of the one before.  Returns
    ``layers`` int32 (nL, 4) = (s0, nq, z0, nn) and ``blk`` (2, nL, WQ, WN),
    WQ = max nq and WN = max nn, with ``blk[0, L, j, i] = NzT[z0 + i, s0 + j]``
    (``blk[1]`` from DzT, zeros past nq and nn).  Raises ValueError on a
    table without that structure."""
    NzT, DzT = np.asarray(NzT), np.asarray(DzT)
    n1z, S = NzT.shape
    if S == 0 or n1z < 2:
        raise ValueError(f"z tables of {n1z} node rows and {S} QP rows have no element layer")
    nz = (NzT != 0) | (DzT != 0)
    lo, hi = _band(nz)
    if (hi < 0).any():
        raise ValueError("z tables: a QP row has no nonzero entry")
    layers, s = [], 0
    while s < S:
        e, z0, z1 = s + 1, lo[s], hi[s]
        while e < S and lo[e] < z1:  # a column that starts below the top row joins the layer
            z0, z1 = min(z0, lo[e]), max(z1, hi[e])
            e += 1
        layers.append((s, e - s, z0, z1 - z0 + 1))
        s = e
    for k, (_, _, z0, nn) in enumerate(layers):
        want = 0 if k == 0 else layers[k - 1][2] + layers[k - 1][3] - 1
        if z0 != want or nn < 2:
            raise ValueError(
                f"z tables have no element-layer structure: layer {k} spans node rows "
                f"{z0}..{z0 + nn - 1}, expected to start at {want} and span at least 2 rows"
            )
    if layers[-1][2] + layers[-1][3] != n1z:
        raise ValueError("z tables have no element-layer structure: the last node rows are never used")
    lay = np.asarray(layers, dtype=np.int32)
    blk = np.zeros((2, len(layers), lay[:, 1].max(), lay[:, 3].max()))
    for k, (s0, nq, z0, nn) in enumerate(layers):
        blk[0, k, :nq, :nn] = NzT[z0 : z0 + nn, s0 : s0 + nq].T
        blk[1, k, :nq, :nn] = DzT[z0 : z0 + nn, s0 : s0 + nq].T
    return lay, blk


def zsweep_tables(NzT: np.ndarray, DzT: np.ndarray, dtype, device) -> ZSweepTables:
    """Device tables for :func:`fused_z_sweep` from host (n1z, S) tables."""
    lay, blk = zsweep_layers(NzT, DzT)
    return ZSweepTables(
        torch.as_tensor(np.asarray(NzT), dtype=dtype, device=device).contiguous(),
        torch.as_tensor(np.asarray(DzT), dtype=dtype, device=device).contiguous(),
        lay,
        torch.as_tensor(lay, device=device).contiguous(),
        torch.as_tensor(blk, dtype=dtype, device=device).contiguous(),
        tuple(int(x) for x in blk.shape[1:]),
    )


@lru_cache(maxsize=64)
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
    count_launch(launches_by_device, b.device.index)
    return out


# ---------------------------------------------------------------------- build


def _declare(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    declare_coefficients(lib, "zsweep")
    for name in ("zsweep_f32", "zsweep_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, ci, vp]
        fn.restype = ci
    lib.zsweep_occupancy.argtypes = [ci] * 7
    lib.zsweep_occupancy.restype = ci


def _library():
    return load("zsweep", _declare)


MAX_ROWS = 12  # threads along a layer's QP rows (csrc/zsweep.cu: ZS_MAXY)
# blocks wanted per SM before z is split across blocks: two resident, two waves
_BLOCKS_PER_SM = 4


@lru_cache(maxsize=256)
def launch_shape(c: int, n_eq: int, K: int, n_ent: int, dims: tuple, RQ: int, itemsize: int, n_sm: int) -> dict:
    """The kernel's launch shape for layers of ``dims = (nL, WQ, WN)``, K
    streamed planes (0 for a constant A) and A's ``n_ent`` nonzero entries:
    ``tq`` columns by ``by`` QP rows of threads, ``chunks`` blocks along z of
    ``CL`` layers each, and ``smem`` bytes of shared memory (the widest column
    tile that fits).  z is split only where the column tiles alone would
    leave the card's ``n_sm`` SMs short of blocks."""
    nL, WQ, WN = dims
    for tq in (32, 16, 8, 4, 2, 1):
        vals = (
            2 * (3 * c * WN * tq + 2 * WQ * WN + K * WQ * tq)  # two layer buffers: nodes, tables, planes
            + 4 * c * WQ * tq  # the QP tile
            + n_eq * WQ * tq  # w * r
            + 3 * c * tq  # the carried node row
            + 2 * n_ent  # A's entries, by equation and by slot
        )
        smem = vals * itemsize + 4 * 4 * n_ent  # and their four offsets
        if smem <= _SMEM_LIMIT:
            break
    else:
        raise ValueError(
            f"fused z-sweep needs {smem} bytes of shared memory for one column "
            f"(c={c}, n_eq={n_eq}, K={K}, layers of {WQ} x {WN}); the limit is {_SMEM_LIMIT}"
        )
    tiles = -(-RQ // tq)
    want = min(nL, max(1, -(-_BLOCKS_PER_SM * n_sm // tiles)))
    CL = -(-nL // want)
    return dict(tq=tq, by=min(WQ, MAX_ROWS), CL=CL, chunks=-(-nL // CL), smem=smem)


@lru_cache(maxsize=None)
def _sm_count(dev: int) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


_edge_rows: dict = {}  # (layers, CL) -> the node rows two chunks share, for the launch


def _chunk_edges(tabs: ZSweepTables, CL: int):
    key = (tabs.layers.tobytes(), CL)
    rows = _edge_rows.get(key)
    if rows is None:
        z = tabs.layers[CL::CL, 2]
        rows = _edge_rows[key] = (ctypes.c_int * len(z))(*z.tolist())
    return rows


def launch(A_const, b, bdy, bdx, geom, tabs: ZSweepTables, var=None, layout: str = "cz"):
    """Launch the CUDA kernel on CUDA tensors (no launch count: each public
    wrapper counts its own launches); raises on what the kernel does not take."""
    no_autograd("zsweep", b, bdy, bdx, geom, var)
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
    ins = [b, bdy, bdx, tabs.NzT, tabs.DzT, tabs.blk] + g + ([] if Anz is None else [Anz])
    for x in ins:
        if x.device != b.device or x.dtype != b.dtype:
            raise ValueError("fused z-sweep inputs must share one device and dtype")
    if bdy.shape != b.shape or bdx.shape != b.shape or tuple(tabs.NzT.shape) != (n1z, S):
        raise ValueError("fused z-sweep: inconsistent b / bdy / bdx / table shapes")
    for x, n in zip(g, sizes):
        if x.numel() != n:
            raise ValueError(f"fused z-sweep: geometry tensor of {x.numel()} values, expected {n}")
    n_eq = A.shape[1]
    dev, stream = device_and_stream(b)
    K = 0 if Anz is None else Anz.shape[0]
    n_ent = upload_coefficients(lib, "zsweep", A, dev, stream, _uploaded)
    sh = launch_shape(c, n_eq, K, n_ent, tabs.dims, RQ, b.element_size(), _sm_count(dev))
    b, bdy, bdx = b.contiguous(), bdy.contiguous(), bdx.contiguous()
    g = [x.contiguous() for x in g] + [None] * (5 - len(g))
    Anz = None if Anz is None else Anz.contiguous()
    out = torch.empty((3,) + tuple(b.shape), dtype=b.dtype, device=b.device)
    a, ady, adx = out.unbind(0)
    fn = lib.zsweep_f32 if b.dtype == torch.float32 else lib.zsweep_f64
    # the node rows two chunks share, which the launch zeroes first: at each, the
    # rows of all (tensor, channel) as (width, pitch, height) in values
    edges = _chunk_edges(tabs, sh["CL"]) if sh["chunks"] > 1 else None
    zero = (RQ, cs, 3 * c) if layout == "cz" else (c * RQ, n1z * c * RQ, 3)
    ptrs = [None if x is None else x.data_ptr() for x in [b, bdy, bdx] + g + [Anz]]
    ptrs += [tabs.blk.data_ptr(), tabs.lay.data_ptr(), a.data_ptr(), ady.data_ptr(), adx.data_ptr()]
    ptrs.append(None if edges is None else ctypes.addressof(edges))
    ints = [c, S, RQ, n_eq, *tabs.dims, sh["CL"], cs, zs, K, n_ent, int(diag), int(var is not None)]
    ints += [sh["tq"], sh["by"], sh["chunks"], sh["smem"], *zero]
    rc = fn((ctypes.c_void_p * 15)(*ptrs), (ctypes.c_int * 21)(*ints), dev, stream)
    if rc != 0:
        raise RuntimeError(f"z-sweep kernel launch failed: CUDA error {rc}")
    return a, ady, adx


def kernel_occupancy(dtype, diag: bool, A, K: int, tabs: ZSweepTables, RQ: int, device=None) -> dict:
    """The launch shape of these inputs on ``device`` (default: the current card; A the constant
    matrix, or ``plane_table`` of a variable one with its K planes), with the
    kernel instantiation's resident blocks per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    dev = device_index(device)
    A = np.ascontiguousarray(A, dtype=np.float64)
    itemsize = torch.empty((), dtype=dtype).element_size()
    n_ent = len(coefficient_tables(A)[3])
    sh = launch_shape(A.shape[2], A.shape[1], K, n_ent, tabs.dims, RQ, itemsize, _sm_count(dev))
    blocks = _library().zsweep_occupancy(
        int(dtype == torch.float64), int(diag), int(K > 0), tabs.dims[2], sh["tq"] * sh["by"], sh["smem"], dev
    )
    if blocks < 0:
        raise RuntimeError(f"z-sweep occupancy query failed: CUDA error {-blocks}")
    return dict(sh, blocks_per_sm=blocks, warps_per_sm=blocks * sh["tq"] * sh["by"] // 32)
