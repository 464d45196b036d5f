"""ctypes loader for the native (C++) AMG-setup kernels.

Compiles tpu_sparse/native/amg_setup.cc with g++ on first use into a cached
shared library (keyed by source hash). Falls back gracefully: callers check
`available()` and use the scipy/numpy path when the toolchain is missing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "amg_setup.cc")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _cache_dir() -> str:
    """Build directory: ``TPU_SPARSE_NATIVE_CACHE`` if set, else the
    git-ignored ``<checkout>/.native_build``."""
    from tpu_sparse.utils.compile_cache import CHECKOUT

    d = os.environ.get("TPU_SPARSE_NATIVE_CACHE",
                       os.path.join(CHECKOUT, ".native_build"))
    os.makedirs(d, exist_ok=True)
    return d


def _build() -> Optional[str]:
    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src).hexdigest()[:16]
    so_path = os.path.join(_cache_dir(), f"amg_setup_{tag}.so")
    if os.path.exists(so_path):
        return so_path
    # per-process temporary name: concurrent first builds (test workers)
    # must not write one file; os.replace publishes atomically
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
           _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so_path)
        return so_path
    except (subprocess.SubprocessError, OSError, FileNotFoundError):
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = _build()
    if so is None:
        return None
    lib = ctypes.CDLL(so)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.ts_aggregate.restype = ctypes.c_int64
    lib.ts_aggregate.argtypes = [ctypes.c_int64, i32p, i32p, f64p,
                                 ctypes.c_double, ctypes.c_int32, i64p]
    lib.ts_rap_pc.restype = ctypes.c_int64
    lib.ts_rap_pc.argtypes = [ctypes.c_int64, ctypes.c_int64, i32p, i32p,
                              f64p, i64p, i32p, i32p, f64p, ctypes.c_int64]
    lib.ts_l1_row_norms.restype = None
    lib.ts_l1_row_norms.argtypes = [ctypes.c_int64, i32p, f64p, f64p]
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.ts_dia_to_csr_f64.restype = None
    lib.ts_dia_to_csr_f64.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int64, i64p, i64p, f64p,
                                      i64p, f64p, i32p]
    lib.ts_dia_to_csr_f32.restype = None
    lib.ts_dia_to_csr_f32.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int64, i64p, i64p, f32p,
                                      i64p, f32p, i32p]
    lib.ts_cwell_planes.restype = None
    lib.ts_cwell_planes.argtypes = [ctypes.c_int64, i64p, i32p, i32p]
    lib.ts_cwell_fill_f32.restype = None
    lib.ts_cwell_fill_f32.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int64, ctypes.c_int64, i64p,
                                      i32p, f32p, f32p, i32p, i32p]
    lib.ts_cwell_fill_f64.restype = None
    lib.ts_cwell_fill_f64.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int64, ctypes.c_int64, i64p,
                                      i32p, f64p, f64p, i32p, i32p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _as(arr, dtype):
    return np.ascontiguousarray(arr, dtype=dtype)


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def aggregate(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
              theta: float, target_size: int) -> Tuple[np.ndarray, int]:
    """Greedy strength-based aggregation. Returns (agg ids, n_aggregates)."""
    lib = _load()
    assert lib is not None
    n = len(indptr) - 1
    indptr = _as(indptr, np.int32)
    indices = _as(indices, np.int32)
    data = _as(data, np.float64)
    agg = np.empty(n, dtype=np.int64)
    na = lib.ts_aggregate(n, _ptr(indptr, ctypes.c_int32),
                          _ptr(indices, ctypes.c_int32),
                          _ptr(data, ctypes.c_double),
                          float(theta), int(target_size),
                          _ptr(agg, ctypes.c_int64))
    return agg, int(na)


def rap_pc(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
           agg: np.ndarray, nc: int
           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Galerkin RAP with piecewise-constant P. Returns coarse CSR arrays."""
    lib = _load()
    assert lib is not None
    n = len(indptr) - 1
    indptr = _as(indptr, np.int32)
    indices = _as(indices, np.int32)
    data = _as(data, np.float64)
    agg = _as(agg, np.int64)
    cap = int(indptr[-1])
    indptr_c = np.empty(nc + 1, dtype=np.int32)
    indices_c = np.empty(cap, dtype=np.int32)
    data_c = np.empty(cap, dtype=np.float64)
    nnz_c = lib.ts_rap_pc(n, int(nc), _ptr(indptr, ctypes.c_int32),
                          _ptr(indices, ctypes.c_int32),
                          _ptr(data, ctypes.c_double),
                          _ptr(agg, ctypes.c_int64),
                          _ptr(indptr_c, ctypes.c_int32),
                          _ptr(indices_c, ctypes.c_int32),
                          _ptr(data_c, ctypes.c_double), cap)
    if nnz_c < 0:
        raise RuntimeError("rap_pc capacity overflow")
    return indptr_c, indices_c[:nnz_c].copy(), data_c[:nnz_c].copy()


def dia_to_csr(data: np.ndarray, offsets, shape
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Row-parallel DIA→CSR: (csr_data, indices, indptr).

    ``data`` is (ndiag, n) row-indexed (data[d, i] = A[i, i+offsets[d]]);
    keeps explicit in-band zeros, sorted columns per row.
    """
    lib = _load()
    assert lib is not None
    n, m = shape
    data = np.ascontiguousarray(data)
    offs = np.asarray(offsets, dtype=np.int64)
    dorder = np.argsort(offs, kind="stable").astype(np.int64)
    offs_s = np.ascontiguousarray(offs[dorder])
    i = np.arange(n, dtype=np.int64)
    counts = (np.searchsorted(offs_s, m - i)
              - np.searchsorted(offs_s, -i))
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    nnz = int(indptr[-1])
    out = np.empty(nnz, dtype=data.dtype)
    indices = np.empty(nnz, dtype=np.int32)
    if data.dtype == np.float64:
        fn, ct = lib.ts_dia_to_csr_f64, ctypes.c_double
    elif data.dtype == np.float32:
        fn, ct = lib.ts_dia_to_csr_f32, ctypes.c_float
    else:
        raise TypeError(f"unsupported dtype {data.dtype}")
    fn(n, m, offs_s.size, _ptr(offs_s, ctypes.c_int64),
       _ptr(dorder, ctypes.c_int64), _ptr(data, ct),
       _ptr(indptr, ctypes.c_int64), _ptr(out, ct),
       _ptr(indices, ctypes.c_int32))
    if nnz <= np.iinfo(np.int32).max:
        indptr = indptr.astype(np.int32)
    return out, indices, indptr


def l1_row_norms(indptr: np.ndarray, data: np.ndarray) -> np.ndarray:
    lib = _load()
    assert lib is not None
    n = len(indptr) - 1
    indptr = _as(indptr, np.int32)
    data = _as(data, np.float64)
    out = np.empty(n, dtype=np.float64)
    lib.ts_l1_row_norms(n, _ptr(indptr, ctypes.c_int32),
                        _ptr(data, ctypes.c_double),
                        _ptr(out, ctypes.c_double))
    return out


def cwell_pack(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
               shape: Tuple[int, int], plane_pad: int = 8):
    """Pack CSR arrays into CWELL (vals, idx2, srow, S) via the C++
    kernels: two streaming passes, threaded over row blocks, each output
    element written once (the numpy pipeline's ~20 fresh intermediates
    cost ~6 s/GB in page faults on this host). Requires column-sorted
    indices. Returns None if the native library is unavailable or the
    dtype is unsupported."""
    lib = _load()
    if lib is None:
        return None
    if data.dtype == np.float32:
        fill_fn, ct = lib.ts_cwell_fill_f32, ctypes.c_float
    elif data.dtype == np.float64:
        fill_fn, ct = lib.ts_cwell_fill_f64, ctypes.c_double
    else:
        return None
    n, m = shape
    LW = 128
    nb = max((n + LW - 1) // LW, 1)
    m_pad = max(((m + LW - 1) // LW) * LW, 2 * LW)
    rmax = m_pad // LW - 2
    indptr = _as(indptr, np.int64)
    indices = _as(indices, np.int32)
    data = np.ascontiguousarray(data)
    S_b = np.empty(nb, dtype=np.int32)
    lib.ts_cwell_planes(n, _ptr(indptr, ctypes.c_int64),
                        _ptr(indices, ctypes.c_int32),
                        _ptr(S_b, ctypes.c_int32))
    S = max(int(S_b.max()) if nb else 1, 1)
    S = (S + plane_pad - 1) // plane_pad * plane_pad
    vals = np.zeros((nb, S, LW), dtype=data.dtype)
    idx2 = np.zeros((nb, S, LW), dtype=np.int32)
    srow = np.zeros((nb, S), dtype=np.int32)
    fill_fn(n, m, S, rmax, _ptr(indptr, ctypes.c_int64),
            _ptr(indices, ctypes.c_int32), _ptr(data, ct),
            _ptr(vals, ct), _ptr(idx2, ctypes.c_int32),
            _ptr(srow, ctypes.c_int32))
    return vals, idx2, srow, S
