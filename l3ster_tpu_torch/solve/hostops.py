"""Host helpers of the preconditioners' setup: ILU(0) and triangular-solve levels.

``csrc/hostops.cpp`` holds the two sequential CSR passes in C++: the
zero-fill incomplete LU factorization (``ilu0_factor_csr``) and the
topological levels of a triangular solve (``tri_levels``).  It is compiled
with the host C++ compiler (``$CXX``, else ``c++``) at first use into
``l3ster_tpu_torch/_build/hostops-<hash>.so`` (the hash covers the source, so
an edited source builds anew) and loaded with ``ctypes``.  Where it cannot be
built, numpy versions of the same arithmetic run instead (a row loop in
Python: minutes at production sizes), with a warning; ``backend`` records
which one each function last ran, and :func:`available` says whether the
library loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import warnings

import numpy as np

__all__ = ["available", "backend", "ilu0_factor_csr", "tri_levels"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "hostops.cpp")
_BUILD_DIR = os.path.join(_PKG, "_build")

backend: dict = {}  # function name -> "native" or "numpy", for its last call
_state: dict = {}  # "lib": the loaded library, or None once a build failed


def _library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"hostops-{digest}.so")


def _build(path: str) -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "c++"), "-O3", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp]
    subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    os.replace(tmp, path)  # atomic: a concurrent build never sees a partial file


def _load():
    """The loaded library, built if needed; None when it cannot be built."""
    if "lib" in _state:
        return _state["lib"]
    path = _library_path()
    try:
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
    except (OSError, subprocess.SubprocessError) as e:
        warnings.warn(f"hostops: the C++ helper did not build ({e}); using the numpy versions", RuntimeWarning)
        _state["lib"] = None
        return None
    i64p, i64 = ctypes.POINTER(ctypes.c_int64), ctypes.c_int64
    lib.ilu0_factor_csr.argtypes = [ctypes.POINTER(ctypes.c_double), i64p, i64p, i64]
    lib.ilu0_factor_csr.restype = i64
    lib.tri_levels.argtypes = [i64p, i64p, i64, ctypes.c_int, i64p]
    lib.tri_levels.restype = None
    _state["lib"] = lib
    return lib


def available() -> bool:
    """Whether the C++ helper is built and loaded (builds it on first call)."""
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _csr_index(indices, indptr, n: int):
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    ptr = np.ascontiguousarray(indptr, dtype=np.int64)
    if ptr.shape != (n + 1,) or ptr[0] != 0 or ptr[-1] != len(idx) or (len(idx) and not (0 <= idx.min() and idx.max() < n)):
        raise ValueError("malformed CSR structure")
    return idx, ptr


def ilu0_factor_csr(data, indices, indptr, n: int) -> np.ndarray:
    """Zero-fill incomplete LU on the CSR's own sparsity (columns sorted in
    each row, diagonal present): the factored values, strictly-lower entries
    holding L (unit diagonal implied), diagonal and upper holding U.  Raises
    ValueError on a missing diagonal, ZeroDivisionError on a zero pivot."""
    a = np.array(data, dtype=np.float64, copy=True)
    idx, ptr = _csr_index(indices, indptr, n)
    if len(a) != len(idx):
        raise ValueError("CSR data and indices differ in length")
    lib = _load()
    if lib is None:
        backend["ilu0_factor"] = "numpy"
        return _ilu0_numpy(a, idx, ptr, n)
    backend["ilu0_factor"] = "native"
    rc = lib.ilu0_factor_csr(a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), _ptr(idx), _ptr(ptr), int(n))
    if rc == np.iinfo(np.int64).min:
        raise ValueError("ILU0 requires explicit diagonal entries")
    if rc < 0:
        raise ZeroDivisionError(f"ILU0 breakdown: zero pivot at row {-int(rc) - 1}")
    return a


def _ilu0_numpy(a, indices, indptr, n: int) -> np.ndarray:
    diag_pos = np.empty(n, dtype=np.int64)
    for i in range(n):
        s, e = indptr[i], indptr[i + 1]
        dp = s + np.searchsorted(indices[s:e], i)
        if dp >= e or indices[dp] != i:
            raise ValueError("ILU0 requires explicit diagonal entries")
        diag_pos[i] = dp
    for i in range(n):
        s, e = indptr[i], indptr[i + 1]
        cols_i = indices[s:e]
        for kk in range(s, diag_pos[i]):
            k = indices[kk]
            akk = a[diag_pos[k]]
            if akk == 0.0:
                raise ZeroDivisionError(f"ILU0 breakdown: zero pivot at row {k}")
            lik = a[kk] / akk
            a[kk] = lik
            ks, ke = diag_pos[k] + 1, indptr[k + 1]
            if ks >= ke:
                continue
            ck = indices[ks:ke]
            pos = np.searchsorted(cols_i, ck)
            posc = np.minimum(pos, len(cols_i) - 1)
            hit = (pos < len(cols_i)) & (cols_i[posc] == ck)
            a[s + pos[hit]] -= lik * a[ks:ke][hit]
    return a


def tri_levels(indices, indptr, n: int, lower: bool) -> np.ndarray:
    """Topological level of each row of a (strictly) lower or upper
    triangular solve: 1 + the largest level among the row's dependencies."""
    idx, ptr = _csr_index(indices, indptr, n)
    lib = _load()
    if lib is None:
        backend["tri_levels"] = "numpy"
        return _levels_numpy(idx, ptr, n, lower)
    backend["tri_levels"] = "native"
    out = np.zeros(int(n), dtype=np.int64)
    lib.tri_levels(_ptr(idx), _ptr(ptr), int(n), 1 if lower else 0, _ptr(out))
    return out


def _levels_numpy(indices, indptr, n: int, lower: bool) -> np.ndarray:
    level = np.zeros(n, dtype=np.int64)
    for i in range(n) if lower else range(n - 1, -1, -1):
        deps = indices[indptr[i] : indptr[i + 1]]
        deps = deps[deps < i] if lower else deps[deps > i]
        if len(deps):
            level[i] = level[deps].max() + 1
    return level
