"""Per-QP least-squares algebra of the dense apply: a Hopper CUDA kernel and its plain version.

Port of the Pallas TPU kernel ``l3ster_tpu/ops/pallas_qp.py:qp_algebra_const_pallas``:
every quadrature point runs ``g_phys = J^-T g_ref``, ``r = A g``, ``w r``,
``t = A^T (w r)``, ``t_ref = J^-1 t`` with a constant A, in 2D or 3D.  One
kernel source (``csrc/qp_algebra.cu``, which has the design note) reads and
writes two layouts in place:

* the dense-basis apply's (E, c, d1, Q), between its two basis matmuls
  (``algsys/local.py:local_apply_dense_const``): :func:`qp_algebra_const`;
* the lattice chain's row stack (d1*c, EQ), rows d*c+u, the TPU kernel's own
  layout (``ops/lattice_sumfact.py``, pipeline "chain_qp"):
  :func:`qp_algebra_const_lattice`.

Each dispatcher runs its plain version (the torch ``_qp_algebra_const`` chain
of ``algsys/local.py``) on a CPU tensor, and launches the kernel on a CUDA
tensor or raises.  The kernel walks tiles of QPs through a shared-memory
ring on a persistent grid: :func:`launch_shape` sizes the ring,
:func:`kernel_occupancy` adds the card's resident blocks and the grid.
``launch_count`` counts kernel launches of both layouts, ``launches_by_device``
the same launches by device index.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ._cuda import (
    CA_LIMITS,
    SMEM_LIMIT,
    count_launch,
    coefficient_tables,
    declare_coefficients,
    device_and_stream,
    device_index,
    load,
    no_autograd,
    upload_coefficients,
)

__all__ = [
    "qp_algebra_const",
    "qp_algebra_const_plain",
    "qp_algebra_const_lattice",
    "qp_algebra_const_lattice_plain",
    "launch_shape",
    "kernel_occupancy",
]

launch_count = 0  # kernel launches; read and reset by callers that check the path
launches_by_device: dict = {}  # the same launches by CUDA device index
# per device: the coefficient set last uploaded to the kernel's __constant__ memory
_uploaded: dict = {}


def qp_algebra_const_plain(A_const, G: torch.Tensor, Ji_t: torch.Tensor, w_t: torch.Tensor):
    """Plain torch version: T (E, c, d1, Q) from G (E, c, d1, Q), Ji_t (dim, dim, EQ)
    and w_t (EQ,), with EQ = E * Q in element-major order: the lattice layout's
    plain version on G's rows."""
    E, c, d1, Q = G.shape
    g = G.permute(2, 1, 0, 3).reshape(d1 * c, E * Q)
    T = qp_algebra_const_lattice_plain(A_const, g, Ji_t.reshape(-1, E * Q), w_t)
    return T.reshape(d1, c, E, Q).permute(2, 1, 0, 3).contiguous()


def qp_algebra_const(A_const, G: torch.Tensor, Ji_t: torch.Tensor, w_t: torch.Tensor):
    """T (E, c, d1, Q) of the per-QP chain: the CUDA kernel for CUDA tensors,
    :func:`qp_algebra_const_plain` for CPU tensors."""
    if G.device.type == "cpu":
        return qp_algebra_const_plain(A_const, G, Ji_t, w_t)
    if G.device.type != "cuda":
        raise ValueError(f"qp_algebra_const runs on CPU or CUDA tensors, got {G.device}")
    E, c, d1, Q = G.shape
    return _launch(A_const, G, Ji_t, w_t, c, d1, Q, lattice=False)


def qp_algebra_const_lattice_plain(A_const, g: torch.Tensor, ji: torch.Tensor, w: torch.Tensor):
    """Plain torch version on the lattice layout: t (d1*c, EQ) from the row
    stack g (d1*c, EQ), rows d*c+u, ji (dim*dim, EQ), row j*dim+i holding
    J^-1[j, i], and w (EQ,)."""
    from ..algsys.local import _qp_algebra_const

    A = np.asarray(A_const, np.float64)
    d1, c, EQ = A.shape[0], A.shape[2], g.shape[1]
    dim = d1 - 1
    vals_l = [g[u] for u in range(c)]
    rd = [[g[(1 + j) * c + u] for u in range(c)] for j in range(dim)]
    t0, tr = _qp_algebra_const(A, ji.reshape(dim, dim, EQ), w, vals_l, rd, dim, c, g.dtype)
    return torch.stack(list(t0) + [tj for j in range(dim) for tj in tr[j]])


def qp_algebra_const_lattice(A_const, g: torch.Tensor, ji: torch.Tensor, w: torch.Tensor):
    """t (d1*c, EQ) of the per-QP chain on the lattice chain's row stack: the
    CUDA kernel for CUDA tensors, :func:`qp_algebra_const_lattice_plain` for
    CPU tensors."""
    if g.device.type == "cpu":
        return qp_algebra_const_lattice_plain(A_const, g, ji, w)
    if g.device.type != "cuda":
        raise ValueError(f"qp_algebra_const_lattice runs on CPU or CUDA tensors, got {g.device}")
    d1 = np.asarray(A_const).shape[0]
    c = g.shape[0] // d1
    if g.dim() != 2 or g.shape[0] != d1 * c:
        raise ValueError(f"g must be (d1*c, EQ) = ({d1}*c, EQ), got {tuple(g.shape)}")
    return _launch(A_const, g, ji.reshape(d1 - 1, d1 - 1, -1), w, c, d1, g.shape[1], lattice=True)


RING = 3  # tiles of the kernel's ring at most: two in flight while one computes


def _declare(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    declare_coefficients(lib, "qp")
    for name in ("qp_f32", "qp_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [vp] * 4 + [ci] * 9 + [ctypes.c_uint] + [ci] * 4 + [vp]
        fn.restype = ci
    lib.qp_occupancy.argtypes = [ci] * 7
    for name in ("qp_threads", "qp_tile", "qp_occupancy", "qp_sm_count"):
        getattr(lib, name).restype = ci
    lib.qp_sm_count.argtypes = [ci]


def _library():
    return load("qp_algebra", _declare)


def _tile_shape() -> tuple[int, int]:
    """(threads a block, QPs a tile) of the kernel's full tile, compile-time
    constants of ``csrc/qp_algebra.cu``."""
    lib = _library()
    return lib.qp_threads(), lib.qp_tile()


def fast_div(d: int) -> tuple[int, int]:
    """(mul, shr) with ``n // d == (n * mul >> 32) >> shr`` for 0 <= n < 2^31
    (``mul == 0``: d == 1), the kernel's division of a QP index by Q."""
    if d == 1:
        return 0, 0
    p = 31 + (d - 1).bit_length()
    return -(-(1 << p) // d), p - 32


SMALL_TILES = (128, 64, 32)  # the kernel's smaller tiles, one QP a thread


def launch_shape(dim: int, c: int, n_eq: int, n_ent: int, itemsize: int, tile: int) -> dict:
    """The kernel's tile ring for A's ``n_ent`` nonzero entries: ``nbuf``
    tiles of ``tile`` QPs (the full tile, RING of them where they fit, else
    fewer; where one full tile does not fit, the largest of
    :data:`SMALL_TILES` that does) and ``smem`` bytes.  Raises past the
    ``__constant__`` tables' limits (``ops/_cuda.py:CA_LIMITS``), which every
    A within them fits at the smallest tile."""
    S = (dim + 1) * c
    max_ent, max_eq, max_slot = CA_LIMITS
    if n_ent > max_ent or n_eq > max_eq or S > max_slot:
        raise ValueError(
            f"A has {n_ent} nonzeros, {n_eq} equations, {S} slots: over the kernel's constant tables "
            f"({max_ent}, {max_eq}, {max_slot})"
        )
    R = S + dim * dim + 1  # rows of a tile: G's slots, the J^-1 planes, w
    for t in (tile,) + tuple(x for x in SMALL_TILES if x < tile):
        for nbuf in range(RING, 0, -1):
            smem = (nbuf * R + n_eq) * t * itemsize + 8 * R + (2 * n_ent + S) * itemsize + (4 * n_ent + 2 * S) * 4
            if smem <= SMEM_LIMIT:
                return dict(tile=t, rows=R, nbuf=nbuf, smem=smem)
    raise ValueError(f"qp_algebra_const needs {smem} bytes of shared memory for one tile; the limit is {SMEM_LIMIT}")


@lru_cache(maxsize=64)
def _resident(f64: bool, dim: int, c: int, lattice: bool, tile: int, smem: int, dev: int) -> tuple[int, int]:
    """(resident blocks per SM of the instantiation, SMs of the card)."""
    lib = _library()
    blocks, sms = lib.qp_occupancy(int(f64), dim, c, int(lattice), tile, smem, dev), lib.qp_sm_count(dev)
    if blocks <= 0 or sms <= 0:
        raise RuntimeError(f"qp_algebra occupancy query failed: {blocks}, {sms}")
    return blocks, sms


def kernel_occupancy(dtype, A_const, dim: int, c: int, EQ: int, lattice: bool, device=None) -> dict:
    """The launch shape on ``device`` (default: the current card): the tile
    ring, the block width, resident blocks per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and the persistent
    grid over ``EQ`` QPs."""
    A = np.ascontiguousarray(A_const, dtype=np.float64)
    itemsize = torch.empty((), dtype=dtype).element_size()
    full_threads, full_tile = _tile_shape()
    sh = launch_shape(dim, c, A.shape[1], len(coefficient_tables(A)[3]), itemsize, full_tile)
    threads = full_threads if sh["tile"] == full_tile else sh["tile"]
    dev = device_index(device)
    blocks, sms = _resident(dtype == torch.float64, dim, c, lattice, sh["tile"], sh["smem"], dev)
    tiles = -(-EQ // sh["tile"])
    return dict(
        sh, threads=threads, blocks_per_sm=blocks, warps_per_sm=blocks * threads // 32, tiles=tiles,
        grid=min(tiles, blocks * sms),
    )


def _launch(A_const, G, Ji_t, w_t, c: int, d1: int, Q: int, lattice: bool):
    """Checks and launch, for G (E, c, d1, Q) or, with ``lattice``, the row
    stack G (d1*c, EQ) (then Q is EQ, one element)."""
    global launch_count
    no_autograd("qp_algebra", G, Ji_t, w_t)
    lib = _library()
    A = np.ascontiguousarray(A_const, dtype=np.float64)
    dim, EQ = d1 - 1, G.numel() // (c * d1)
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
    if max(G.numel(), Ji_t.numel()) >= 2**31:
        raise ValueError("qp_algebra_const: G or Ji_t has 2^31 or more values")
    n_eq, es = A.shape[1], G.element_size()
    sh = launch_shape(dim, c, n_eq, len(coefficient_tables(A)[3]), es, _tile_shape()[1])
    tile = sh["tile"]
    G, Ji_t, w_t = G.contiguous(), Ji_t.contiguous(), w_t.contiguous()
    out = torch.empty_like(G)
    if EQ == 0:
        return out
    dev, stream = device_and_stream(G)
    upload_coefficients(lib, "qp", A, dev, stream, _uploaded)
    blocks, sms = _resident(G.dtype == torch.float64, dim, c, lattice, tile, sh["smem"], dev)
    # 16-byte copies where every row starts 16-byte aligned and no vector straddles an element
    vec = Q % (16 // es) == 0 and all(t.data_ptr() % 16 == 0 for t in (G, Ji_t, w_t, out))
    qmul, qshr = fast_div(Q)
    fn = lib.qp_f32 if G.dtype == torch.float32 else lib.qp_f64
    rc = fn(
        G.data_ptr(), Ji_t.data_ptr(), w_t.data_ptr(), out.data_ptr(), EQ, Q, c, dim, n_eq, int(lattice),
        int(vec), sh["nbuf"], tile, qmul, qshr, min(-(-EQ // tile), blocks * sms), sh["smem"], dev, stream,
    )
    if rc != 0:
        raise RuntimeError(f"qp_algebra kernel launch failed: CUDA error {rc}")
    launch_count += 1
    count_launch(launches_by_device, dev)
    return out
