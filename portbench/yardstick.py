"""The benchmark's frozen arithmetic: peaks, timers, operation and byte counts.

Copied here so that a change to the program cannot move the yardstick:

* the H100's published peaks, from NVIDIA's data sheet (SXM part, 700 W);
* :func:`cuda_ms`, from ``chip_smoke.py:_cuda_ms`` (CUDA events around
  back-to-back calls, the median over repetitions);
* :func:`bound`, from ``chip_smoke.py:_bound``;
* :func:`flops_per_apply`, from ``bench.py:_flops_per_apply`` (the
  sum-factorized count of one constrained 3D apply);
* :func:`zsweep_bytes_flops`, from ``chip_smoke.py:_zsweep_bound`` (the z-sweep
  kernel's inputs and outputs and its banded FMAs, from shapes alone);
* :func:`qp_bytes_flops`, from ``chip_smoke.py:_qp_flops`` and the byte count
  of ``PERF.md``'s kernel table (the per-QP kernel's inputs and outputs).

Every timer here needs a CUDA device and raises without one.
"""

from __future__ import annotations

import statistics
import subprocess

PEAK_BYTES = 3.35e12  # HBM3 bytes/s
PEAK_F32_FLOPS = 67e12  # float32 FLOP/s outside the tensor cores
F32 = 4  # bytes


def _need_cuda():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("this measurement needs a CUDA device; it never falls back to the CPU")
    return torch


def cuda_ms(fn, reps: int = 20, batch: int = 10, warm: int = 3) -> float:
    """Milliseconds per fn() call: the median over ``reps`` CUDA-event pairs,
    each around ``batch`` back-to-back calls, after ``warm`` calls.  Back-to-
    back calls let the device run ahead of the host where the host is
    faster: device time for device-bound calls, host time otherwise."""
    torch = _need_cuda()
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(least seconds, what bounds it): bytes at peak bandwidth against
    operations at the float32 peak."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def flops_per_apply(order: int, n_elems: int, n_unk: int, n_eq: int, q1: int) -> int:
    """Useful FLOPs of one sum-factorized constrained apply (3D)."""
    n = order + 1
    c = n_unk
    f = 0
    f += 2 * (2 * n * n * q1 * c * n)  # x-stage
    f += 3 * (2 * n * q1 * q1 * c * n)  # y-stage
    f += 4 * (2 * q1 * q1 * q1 * c * n)  # z-stage
    Q = q1**3
    f += 2 * Q * 9 * c  # J^-T transform of derivatives
    f += 2 * Q * 4 * n_eq * c  # r = A g
    f += Q * n_eq  # weighting
    f += 2 * Q * 4 * n_eq * c  # t = A^T r
    f += 2 * Q * 9 * c  # J^-1 transform back
    f += 4 * (2 * q1 * q1 * n * c * q1)
    f += 3 * (2 * q1 * n * n * c * q1)
    f += 2 * (2 * n * n * n * c * q1)
    return f * n_elems


def apply_bytes(n_dofs: int, n_elems: int, n_elem_nodes: int, unstructured: bool) -> int:
    """Bytes of one apply as the work itself needs them: the vector in and
    out in float32, and the mesh as it is given (8 float32 vertex
    coordinates an element; on an unstructured mesh also its element-node
    connectivity as int32).  Intermediate arrays do not count."""
    mesh = n_elems * 8 * 3 * F32 + (n_elems * n_elem_nodes * 4 if unstructured else 0)
    return 2 * n_dofs * F32 + mesh


def zsweep_bytes_flops(ne: int, order: int, q1: int, c: int, nnz: int) -> tuple[int, int]:
    """(bytes, FLOPs) of one z-sweep call over a cube lattice of ne^3
    elements with constant coefficients and axis-aligned (diagonal)
    geometry: the six (c, n1z, RQ) b/a tensors, the diagonal geometry and
    the two banded z tables moved once; the FMAs of the nonzero table band
    (interpolation and transpose) and of the per-QP algebra."""
    n1z, S = ne * order + 1, ne * q1
    RQ = S * S
    band = ne * q1 * (order + 1)  # nonzero entries of one banded table
    nbytes = F32 * (6 * c * n1z * RQ + 3 * RQ + 2 * S + 2 * band)
    flops = 16 * c * RQ * band + S * RQ * (4 * nnz + 7 + 6 * c)
    return nbytes, flops


def qp_bytes_flops(n_elems: int, q1: int, c: int, nnz: int, n_eq: int, dim: int = 3) -> tuple[int, int]:
    """(bytes, FLOPs) of one per-QP kernel call on the (E, c, d1, Q) layout:
    the value/derivative tensor in and out, the 9 inverse-Jacobian planes and
    the weights; J^-T and J^-1 (dim^2 c FMAs each), r = A g and t = A^T r
    (nnz FMAs each), the weighting."""
    EQ = n_elems * q1**dim
    d1 = dim + 1
    nbytes = F32 * (2 * EQ * c * d1 + dim * dim * EQ + EQ)
    flops = EQ * (4 * dim * dim * c + 4 * nnz + n_eq)
    return nbytes, flops
