"""ctypes loader + lazy build for the native converter library.

pybind11 is not available in this image; the bindings are a plain C ABI
consumed via ctypes (see converters.cpp). The library builds on first use
with g++ (-O3 -fopenmp) and is cached next to the source keyed by a source
hash; any failure degrades silently to the numpy packers (formats/*.py),
which produce bit-identical output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "converters.cpp")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | bool | None = None  # None=untried, False=unavailable


def _build() -> str | None:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(_DIR, f"_converters_{tag}.so")
    if os.path.exists(so):
        return so
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-fopenmp",
           "-o", so + ".tmp", _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(so + ".tmp", so)
        return so
    except (subprocess.SubprocessError, OSError):
        return None


def _lib() -> ctypes.CDLL | None:
    global _LIB
    with _LOCK:
        if _LIB is None:
            so = _build()
            if so is None:
                _LIB = False
            else:
                lib = ctypes.CDLL(so)
                _declare(lib)
                _LIB = lib
    return _LIB or None


def _declare(lib: ctypes.CDLL) -> None:
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    fp = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.sell_max_window_nnz.argtypes = [fp, i64, i64]
    lib.sell_max_window_nnz.restype = i32
    lib.sell_fill.argtypes = [fp, i64, i64, i64, fp, i8p]
    lib.sell_fill.restype = i32
    lib.csr_count.argtypes = [fp, i64, i64, i32p]
    lib.csr_count.restype = None
    lib.csr_fill.argtypes = [fp, i64, i64, i32p, i32p, fp]
    lib.csr_fill.restype = None
    lib.sell_fill_csr.argtypes = [i32p, i32p, fp, i64, i64, i64,
                                  ctypes.c_void_p, ctypes.c_void_p]
    lib.sell_fill_csr.restype = i32
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.rsell_demand_csr.argtypes = [i32p, i32p, i64, i64, i32p]
    lib.rsell_demand_csr.restype = None
    lib.rsell_fill_csr.argtypes = [i32p, i32p, fp, i64, i64, i64p, fp, i8p]
    lib.rsell_fill_csr.restype = None
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.amg_aggregate.argtypes = [i32p, i32p, f64p, f64p, i64,
                                  ctypes.c_double, i64p]
    lib.amg_aggregate.restype = i64


def available() -> bool:
    return _lib() is not None


def sell_max_window_nnz(a: np.ndarray) -> int | None:
    lib = _lib()
    if lib is None or a.dtype != np.float32:
        return None
    a = np.ascontiguousarray(a)
    return int(lib.sell_max_window_nnz(a, a.shape[0], a.shape[1]))


def sell_fill(a: np.ndarray, w: int) -> tuple[np.ndarray, np.ndarray] | None:
    """(vals, idx) with shapes (nb, nt, w, 128), or None if unavailable."""
    lib = _lib()
    if lib is None or a.dtype != np.float32:
        return None
    a = np.ascontiguousarray(a)
    mp, np_ = a.shape
    nb, nt = np_ // 128, mp // 128
    vals = np.zeros((nb, nt, w, 128), np.float32)
    idx = np.zeros((nb, nt, w, 128), np.int8)
    if lib.sell_fill(a, mp, np_, w, vals, idx) != 0:
        raise ValueError(f"w={w} overflowed during native sell_fill")
    return vals, idx


def csr_from_dense(a: np.ndarray):
    """(row_ptr, col_idx, values) for CSR of A.T, or None if unavailable."""
    lib = _lib()
    if lib is None or a.dtype != np.float32:
        return None
    a = np.ascontiguousarray(a)
    m, n = a.shape
    cnt = np.zeros(n, np.int32)
    lib.csr_count(a, m, n, cnt)
    row_ptr = np.zeros(n + 1, np.int32)
    np.cumsum(cnt, out=row_ptr[1:])
    nnz = int(row_ptr[-1])
    col_idx = np.zeros(nnz, np.int32)
    values = np.zeros(nnz, np.float32)
    lib.csr_fill(a, m, n, row_ptr, col_idx, values)
    return row_ptr, col_idx, values


def sell_fill_csr(row_ptr: np.ndarray, col_idx: np.ndarray,
                  values: np.ndarray, n: int, nt: int,
                  w: int | None) -> tuple | None:
    """(vals, idx, w) straight from CSR arrays, or None if unavailable.
    With w=None, a first counting pass picks the width."""
    lib = _lib()
    if lib is None or values.dtype != np.float32:
        return None
    row_ptr = np.ascontiguousarray(row_ptr, np.int32)
    col_idx = np.ascontiguousarray(col_idx, np.int32)
    values = np.ascontiguousarray(values, np.float32)
    if w is None:
        mx = int(lib.sell_fill_csr(row_ptr, col_idx, values, n, nt, 0,
                                   None, None))
        w = max(((mx + 7) // 8) * 8, 8)
    nb = -(-n // 128)
    vals = np.zeros((nb, nt, w, 128), np.float32)
    idx = np.zeros((nb, nt, w, 128), np.int8)
    ret = int(lib.sell_fill_csr(row_ptr, col_idx, values, n, nt, w,
                                vals.ctypes.data, idx.ctypes.data))
    if ret < 0:
        raise ValueError(f"w={w} overflowed during native sell_fill_csr")
    return vals, idx, w


def rsell_demand_csr(row_ptr: np.ndarray, col_idx: np.ndarray, n: int,
                     nt: int) -> np.ndarray | None:
    """(nb, nt) int32 per-tile width demand from CSR arrays, or None."""
    lib = _lib()
    if lib is None:
        return None
    row_ptr = np.ascontiguousarray(row_ptr, np.int32)
    col_idx = np.ascontiguousarray(col_idx, np.int32)
    nb = -(-n // 128)
    demand = np.zeros((nb, nt), np.int32)
    lib.rsell_demand_csr(row_ptr, col_idx, n, nt, demand)
    return demand


def rsell_fill_csr(row_ptr: np.ndarray, col_idx: np.ndarray,
                   values: np.ndarray, n: int, nt: int,
                   tile_chunk_base: np.ndarray,
                   nchunk: int) -> tuple | None:
    """(vals, idx) chunk payloads, or None if unavailable (fp32 only)."""
    lib = _lib()
    if lib is None or values.dtype != np.float32:
        return None
    row_ptr = np.ascontiguousarray(row_ptr, np.int32)
    col_idx = np.ascontiguousarray(col_idx, np.int32)
    values = np.ascontiguousarray(values, np.float32)
    base = np.ascontiguousarray(tile_chunk_base, np.int64)
    vals = np.zeros((nchunk, 8, 128), np.float32)
    idx = np.zeros((nchunk, 8, 128), np.int8)
    lib.rsell_fill_csr(row_ptr, col_idx, values, n, nt, base, vals, idx)
    return vals, idx


def amg_aggregate(indptr: np.ndarray, indices: np.ndarray,
                  absdata: np.ndarray, diagabs: np.ndarray,
                  theta: float) -> tuple[np.ndarray, int] | None:
    """Vanek 3-pass aggregation over CSR arrays (amg.py), or None if the
    native library is unavailable. Bit-identical to the numpy reference
    path (asserted in tests); ~100x faster on 1M-node graphs."""
    lib = _lib()
    if lib is None:
        return None
    n = len(indptr) - 1
    # The C path takes int32 CSR arrays; nnz >= 2^31 would wrap silently
    # and corrupt the aggregation (advisor r2). Fall back to the int64
    # numpy path instead of casting.
    if n > np.iinfo(np.int32).max or \
            (len(indptr) and int(indptr[-1]) > np.iinfo(np.int32).max):
        return None
    indptr = np.ascontiguousarray(indptr, np.int32)
    indices = np.ascontiguousarray(indices, np.int32)
    absdata = np.ascontiguousarray(absdata, np.float64)
    diagabs = np.ascontiguousarray(diagabs, np.float64)
    agg = np.empty(n, np.int64)
    n_agg = lib.amg_aggregate(indptr, indices, absdata, diagabs, n,
                              float(theta), agg)
    return agg, int(n_agg)
