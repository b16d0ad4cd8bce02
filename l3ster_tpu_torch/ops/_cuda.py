"""Build, load and feed the port's hand-written CUDA kernels (``csrc/*.cu``).

Each kernel source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, at first use, into
``l3ster_tpu_torch/_build/<name>-<hash>.so``; the hash covers the source and
the ``csrc/*.cuh`` headers it includes, directly or not, so an edited source
builds anew.  The library is loaded with ``ctypes``.  :func:`build` starts one
``nvcc`` per missing library, all at once.

The per-QP kernels (z-sweep, per-QP algebra, fused sum-factorized apply) bake
a coefficient matrix A (d1, n_eq, c) into ``__constant__`` memory
(``csrc/const_coeffs.cuh``): :func:`coefficient_tables` packs its nonzero
entries twice, grouped by equation (for ``r = A g``) and by (d, u) slot (for
``t = A^T r``), and :func:`upload_coefficients` skips the upload when the same
A was last uploaded to that device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
from functools import lru_cache

import numpy as np
import torch

__all__ = [
    "SMEM_LIMIT",
    "CA_LIMITS",
    "build",
    "load",
    "build_logs",
    "coefficient_tables",
    "upload_coefficients",
    "device_and_stream",
    "count_launch",
    "device_index",
    "no_autograd",
]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD_DIR = os.path.join(_PKG, "_build")
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
# (entries, equations, slots) of the __constant__ coefficient tables: CA_MAX_ENT,
# CA_MAX_EQ and CA_MAX_SLOT of csrc/const_coeffs.cuh (a card test holds them equal)
CA_LIMITS = (2048, 64, 256)

build_logs: dict = {}  # name -> nvcc's -Xptxas=-v report of its last build in this process
_libs: dict = {}


def _source_digest(name: str) -> str:
    """Hash of ``csrc/<name>.cu`` and the package headers it includes, directly or not."""
    h = hashlib.sha1()
    todo, seen = [f"{name}.cu"], set()
    while todo:
        fname = todo.pop(0)
        if fname in seen:
            continue
        seen.add(fname)
        with open(os.path.join(_CSRC, fname), "rb") as f:
            src = f.read()
        h.update(src)
        todo += [inc.decode() for inc in re.findall(rb'#include "([^"]+)"', src)]
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    return os.path.join(_BUILD_DIR, f"{name}-{_source_digest(name)}.so")


def build(*names: str) -> dict:
    """Compile the named kernels for sm_90a (those not built yet), one ``nvcc``
    each, all started together; returns {name: library path}.  Raises if
    ``nvcc`` is missing or fails."""
    from torch.utils.cpp_extension import CUDA_HOME

    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return paths
    if CUDA_HOME is None:
        raise RuntimeError(f"nvcc not found (no CUDA toolkit): cannot build {sorted(todo)}")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    procs = {}
    for n, path in todo.items():
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [
            os.path.join(CUDA_HOME, "bin", "nvcc"),
            "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
            "-o", tmp, os.path.join(_CSRC, f"{n}.cu"),
        ]
        procs[n] = (cmd, tmp, path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        ))
    failed = []
    for n, (cmd, tmp, path, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
            continue
        build_logs[n] = err
        os.replace(tmp, path)  # atomic: a concurrent build never sees a partial file
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load(name: str, declare) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built if needed); ``declare(lib)``
    sets its functions' argtypes and restypes once."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name)[name])
        declare(lib)
        _libs[name] = lib
    return lib


@lru_cache(maxsize=64)
def _tables(a_bytes: bytes, shape: tuple):
    A = np.frombuffer(a_bytes, dtype=np.float64).reshape(shape)
    d1, n_eq, c = shape
    eqstart, rd, ru, rval = [0], [], [], []
    for i in range(n_eq):
        for d in range(d1):
            for u in range(c):
                if A[d, i, u] != 0.0:
                    rd.append(d)
                    ru.append(u)
                    rval.append(A[d, i, u])
        eqstart.append(len(rval))
    slotstart, teq, tval = [0], [], []
    for d in range(d1):
        for u in range(c):
            for i in range(n_eq):
                if A[d, i, u] != 0.0:
                    teq.append(i)
                    tval.append(A[d, i, u])
            slotstart.append(len(tval))
    i32, f64 = np.int32, np.float64
    return (
        np.asarray(eqstart, i32), np.asarray(rd, i32), np.asarray(ru, i32), np.asarray(rval, f64),
        np.asarray(slotstart, i32), np.asarray(teq, i32), np.asarray(tval, f64),
    )


def coefficient_tables(A: np.ndarray):
    """Nonzero entries of A (d1, n_eq, c), packed for ``csrc/const_coeffs.cuh``:
    (eqstart, rd, ru, rval) grouped by equation i, so that
    ``r_i = sum_{e in [eqstart[i], eqstart[i+1])} rval[e] * g[rd[e], ru[e]]``,
    and (slotstart, teq, tval) grouped by slot s = d * c + u, so that
    ``t[s] = sum_{e in [slotstart[s], slotstart[s+1])} tval[e] * r[teq[e]]``."""
    A = np.ascontiguousarray(A, dtype=np.float64)
    return _tables(A.tobytes(), A.shape)


def no_autograd(name: str, *inputs) -> None:
    """Raise when autograd records and an input of a kernel launch (tensors,
    nested in tuples or lists) requires grad: the hand-written kernels have no
    backward, so their outputs would silently carry no gradient."""
    from torch.utils._pytree import tree_leaves

    if torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tree_leaves(inputs)
    ):
        raise NotImplementedError(
            f"{name}: an input requires grad, and the hand-written CUDA kernels have no "
            "backward (none is ported; ROADMAP.md). Differentiate with respect to the "
            "right-hand side, or run an operator kind that is plain torch."
        )


def count_launch(by_device: dict, dev: int) -> None:
    """Add one launch on device ``dev`` to a wrapper's per-device count."""
    by_device[dev] = by_device.get(dev, 0) + 1


def device_index(device=None) -> int:
    """The CUDA device index of ``device`` (default, or no index: the current card)."""
    index = None if device is None else torch.device(device).index
    return torch.cuda.current_device() if index is None else index


def device_and_stream(x: torch.Tensor) -> tuple[int, int]:
    """(device index, raw handle of the current stream) for launches on x's card."""
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    return dev, torch.cuda.current_stream(x.device).cuda_stream


def upload_coefficients(lib, prefix: str, A: np.ndarray, dev: int, stream: int, uploaded: dict):
    """Upload A's nonzeros to the library's __constant__ memory on device ``dev``
    (stream-ordered before the next launch on ``stream``) unless ``uploaded``
    records that the same A is already there.  Raises over the kernel's limits.
    Returns the number of A's nonzero entries."""
    A = np.ascontiguousarray(A, dtype=np.float64)
    d1, n_eq, c = A.shape
    tabs = coefficient_tables(A)
    n_ent = len(tabs[3])
    if n_ent > lib.ca_max_entries() or n_eq > lib.ca_max_equations() or d1 * c > lib.ca_max_slots():
        raise ValueError(
            f"A has {n_ent} nonzeros, {n_eq} equations, {d1 * c} slots: over the kernel's limits"
        )
    key = (A.tobytes(), A.shape)
    if uploaded.get(dev) == key:
        return n_ent
    ptrs = [t.ctypes.data for t in tabs]
    rc = getattr(lib, f"{prefix}_set_coeffs")(*ptrs, n_ent, n_eq, d1 * c, dev, stream)
    if rc != 0:
        raise RuntimeError(f"{prefix}: coefficient upload failed: CUDA error {rc}")
    uploaded[dev] = key
    return n_ent


def declare_coefficients(lib, prefix: str) -> None:
    """argtypes of the ``const_coeffs.cuh`` entry points of one library."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, f"{prefix}_set_coeffs")
    fn.argtypes = [vp] * 7 + [ci] * 4 + [vp]
    fn.restype = ci
    for name in ("ca_max_entries", "ca_max_equations", "ca_max_slots"):
        getattr(lib, name).restype = ci
