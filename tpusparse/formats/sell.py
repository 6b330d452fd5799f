"""SELL: sliced-ELL with in-window int8 indices — see kernels/sell_spmv.py.

Converter-side ranking (numpy): the popcount work the reference did per
kernel launch (wsp.cu:37-39) happens once here at pack time; the device
product then does only in-window gathers. ``tpusparse.native``
provides a C++ fast path for this packing when available.
"""

from __future__ import annotations

from typing import Any

import numpy as np

import jax
import jax.numpy as jnp

from tpusparse.utils import round_up

_LANES = 128
_SUB = 8


def sell_pack(a: np.ndarray, w: int | None = None,
              use_native: bool | None = None,
              dtype: Any = None) -> dict[str, Any]:
    """``dtype``: storage dtype for the values (default: keep ``a``'s).
    ``ml_dtypes.bfloat16`` halves value bytes for serving workloads that
    tolerate bf16 value quantization: abs error ~= 4e-3 x sqrt(column nnz)
    x E|v*x| (accumulation stays fp32)."""
    a = np.asarray(a)
    if dtype is not None and np.dtype(dtype) == np.int8:
        # symmetric per-output-column int8 quantization (serving lane):
        # 2 bytes/slot vs fp32's 5; the product dequantizes AFTER the
        # reduction with one per-column scale multiply. abs error
        # ~= (max|v|_col / 254) * sqrt(col nnz) * E|x| — same order as
        # bf16 storage; outside the 1e-3 contract, opt-in.
        p = sell_pack(a, w=w, use_native=use_native)
        vals = p["vals"]
        amax = np.abs(vals).max(axis=(1, 2))          # (nb, 128) per column
        scales = np.maximum(amax, 1e-30) / 127.0
        p["vals"] = np.rint(vals / scales[:, None, None, :]).astype(np.int8)
        p["scales"] = scales.astype(np.float32)
        return p
    if dtype is not None and np.dtype(dtype) != a.dtype:
        p = sell_pack(a, w=w, use_native=use_native)
        p["vals"] = p["vals"].astype(dtype)
        return p
    m, n = a.shape
    mp, np_ = round_up(m, _LANES), round_up(n, _LANES)
    if (mp, np_) != (m, n):
        a = np.pad(a, ((0, mp - m), (0, np_ - n)))
    nt, nb = mp // _LANES, np_ // _LANES

    if use_native is not False and a.dtype == np.float32:
        from tpusparse import native

        if native.available():
            max_nnz = native.sell_max_window_nnz(a)
            if w is None:
                w = max(round_up(max_nnz, _SUB), _SUB)
            elif max_nnz > w:
                raise ValueError(f"w={w} < max window-column nnz {max_nnz}")
            vals, idx = native.sell_fill(a, w)
            return dict(idx=idx, vals=vals, shape=(m, n), padded=(mp, np_),
                        w=w, nnz=int((a != 0).sum()))
        if use_native:
            raise RuntimeError("native converters requested but unavailable")

    # t4[j, t, r, c] = A[t*128 + c, j*128 + r]: rows are output columns,
    # lanes c are in-window contraction offsets.
    t4 = a.reshape(nt, _LANES, nb, _LANES).transpose(2, 0, 3, 1)
    mask = t4 != 0
    row_nnz = mask.sum(axis=-1)                    # (nb, nt, 128)
    max_nnz = int(row_nnz.max()) if row_nnz.size else 0
    if w is None:
        w = max(round_up(max_nnz, _SUB), _SUB)
    elif max_nnz > w:
        raise ValueError(f"w={w} < max window-column nnz {max_nnz}")

    rank = np.cumsum(mask, axis=-1) - mask
    vals = np.zeros((nb, nt, w, _LANES), dtype=a.dtype)
    idx = np.zeros((nb, nt, w, _LANES), dtype=np.int8)
    jj, tt, rr, cc = np.nonzero(mask)
    wslot = rank[mask]
    vals[jj, tt, wslot, rr] = t4[mask]
    idx[jj, tt, wslot, rr] = cc.astype(np.int8)    # 0..127 fits int8

    return dict(idx=idx, vals=vals, shape=(m, n), padded=(mp, np_),
                w=w, nnz=int(mask.sum()))


def _sorted_rows(csr):
    """CSR with col_idx ascending within each row (legal CSR does not
    guarantee it; the slot-ranking here and in the native packer does)."""
    ci = np.asarray(csr.col_idx)
    row_of = np.repeat(np.arange(len(csr.row_ptr) - 1, dtype=np.int64),
                       csr.row_nnz)
    if ci.size == 0 or bool(np.all((row_of[1:] > row_of[:-1])
                                   | (ci[1:] > ci[:-1]))):
        return csr
    order = np.lexsort((ci, row_of))
    from tpusparse.formats.csr import CsrMatrix

    return CsrMatrix(shape=csr.shape, row_ptr=csr.row_ptr,
                     col_idx=ci[order], values=np.asarray(csr.values)[order])


def sell_pack_csr(csr, w: int | None = None,
                  use_native: bool | None = None) -> dict[str, Any]:
    """Pack straight from a ``CsrMatrix`` (CSR of A.T) without ever
    materializing dense A — the ingestion path for matrices too sparse/large
    to round-trip through a dense array (a 100k x 100k d=0.01 matrix is
    40 GB dense, 120 MB as SELL)."""
    m, n = csr.shape
    mp, np_ = round_up(m, _LANES), round_up(n, _LANES)
    nt, nb = mp // _LANES, np_ // _LANES
    csr = _sorted_rows(csr)   # ranking assumes m ascending within each row

    if use_native is not False:
        from tpusparse import native

        if csr.values.dtype == np.float32 and native.available():
            packed = native.sell_fill_csr(csr.row_ptr, csr.col_idx,
                                          csr.values, n, nt, w)
            if packed is not None:
                vals, idx, w_out = packed
                return dict(idx=idx, vals=vals, shape=(m, n),
                            padded=(mp, np_), w=w_out, nnz=int(csr.nnz))
        if use_native:
            raise RuntimeError(
                "native converters requested but unavailable "
                f"(library loaded: {native.available()}, values dtype: "
                f"{csr.values.dtype} — the native packer is fp32-only)")

    jj, t, rank, rr, off, w = _csr_slot_coords(csr, w)
    vals = np.zeros((nb, nt, w, _LANES), dtype=csr.values.dtype)
    idx = np.zeros((nb, nt, w, _LANES), dtype=np.int8)
    vals[jj, t, rank, rr] = csr.values
    idx[jj, t, rank, rr] = off
    return dict(idx=idx, vals=vals, shape=(m, n), padded=(mp, np_),
                w=w, nnz=int(csr.nnz))


def _csr_slot_coords(csr, w: int | None = None):
    """Per-entry slot coordinates in the (nb, nt, w, 128) SELL layout for a
    row-sorted ``CsrMatrix``: (jj, t, rank, rr, off, w). Shared by the
    numpy packer and the trainable-params machinery (autodiff.py), which
    needs the flat slot index of every nonzero to map live values between
    the forward and transpose layouts."""
    from tpusparse.formats.csr import segment_ranks

    n = csr.shape[1]
    row_nnz = csr.row_nnz
    c = np.repeat(np.arange(n, dtype=np.int64), row_nnz)   # output column
    m_idx = csr.col_idx.astype(np.int64)                   # contraction idx
    t = m_idx // _LANES
    off = (m_idx % _LANES).astype(np.int8)
    # entries are sorted by (c, m); rank within each (c, t) run
    rank, _, counts = segment_ranks(c, t)
    max_nnz = int(counts.max()) if counts.size else 0
    if w is None:
        w = max(round_up(max_nnz, _SUB), _SUB)
    elif max_nnz > w:
        raise ValueError(f"w={w} < max window-column nnz {max_nnz}")
    return c // _LANES, t, rank, c % _LANES, off, w


def sell_slot_flat(csr, w: int) -> np.ndarray:
    """Flat index into ``vals.ravel()`` of each entry of the row-sorted
    ``csr`` under the SELL layout with width ``w``."""
    m, n = csr.shape
    nt = round_up(m, _LANES) // _LANES
    jj, t, rank, rr, _, w = _csr_slot_coords(csr, w)
    return ((jj * nt + t) * w + rank) * _LANES + rr


@jax.tree_util.register_pytree_node_class
class SellMatrix:
    def __init__(self, idx: Any, vals: Any, shape, padded, w: int, nnz: int,
                 scales: Any = None):
        self.idx = idx
        self.vals = vals
        self.shape = shape
        self.padded = padded
        self.w = w
        self.nnz = nnz
        self.scales = scales           # (nb, 128) fp32, int8 storage only

    def tree_flatten(self):
        return ((self.idx, self.vals, self.scales),
                (self.shape, self.padded, self.w, self.nnz))

    @classmethod
    def tree_unflatten(cls, aux, children):
        idx, vals, scales = children
        return cls(idx, vals, *aux, scales=scales)

    @classmethod
    def _io_rebuild(cls, aux, leaves):
        """Rebuild from npz leaves: fp32/bf16 storage has no scales leaf
        (a None child is dropped by pytree flattening); int8 carries it."""
        if len(leaves) == 2:
            return cls.tree_unflatten(aux, (*leaves, None))
        if len(leaves) != 3:
            raise ValueError(f"{len(leaves)} leaves, expected 2 or 3")
        return cls.tree_unflatten(aux, tuple(leaves))

    def __repr__(self) -> str:
        return (f"SellMatrix(shape={self.shape}, nnz={self.nnz}, "
                f"w={self.w}, dtype={np.dtype(self.vals.dtype)}, "
                f"{self.device_bytes() / 1e6:.1f} MB)")

    @classmethod
    def from_dense(cls, a: np.ndarray, w: int | None = None,
                   dtype: Any = None) -> "SellMatrix":
        """``dtype=jnp.bfloat16``: half-size value storage; ``dtype='int8'``:
        2 bytes/slot with per-column scales (see sell_pack). Both keep fp32
        accumulation; both are outside the 1e-3 contract — serving lanes."""
        return cls(**sell_pack(a, w=w, dtype=dtype))

    @classmethod
    def from_csr(cls, csr, w: int | None = None) -> "SellMatrix":
        """Pack from ``CsrMatrix`` without materializing dense A."""
        return cls(**sell_pack_csr(csr, w=w))

    def device_bytes(self) -> int:
        vals = self.vals
        total = int(np.prod(vals.shape)) * (vals.dtype.itemsize + 1)
        if self.scales is not None:
            total += int(np.prod(self.scales.shape)) * 4
        return total

    def to_dense(self) -> np.ndarray:
        idx = np.asarray(self.idx)
        vals = np.asarray(self.vals)
        nb, nt, w, _ = vals.shape
        mp, np_ = self.padded
        out_dtype = np.float32 if self.scales is not None else vals.dtype
        a = np.zeros((mp, np_), dtype=out_dtype)
        jj, tt, ww, rr = np.nonzero(vals)
        v = vals[jj, tt, ww, rr]
        if self.scales is not None:                    # dequantize int8
            v = v.astype(np.float32) * np.asarray(self.scales)[jj, rr]
        cc = idx[jj, tt, ww, rr].astype(np.int64)
        a[tt * _LANES + cc, jj * _LANES + rr] = v
        return a[:self.shape[0], :self.shape[1]]

    def _run(self, x2d: jax.Array) -> jax.Array:
        from tpusparse.kernels.sell_spmv import sell_spmm_padded

        mp, _ = self.padded
        if x2d.shape[1] != mp:
            x2d = jnp.pad(x2d, ((0, 0), (0, mp - x2d.shape[1])))
        out = sell_spmm_padded(self.idx, self.vals, x2d, self.scales)
        return out[:, :self.shape[1]]                  # (B, n)

    def spmv(self, x: Any) -> jax.Array:
        return self._run(jnp.asarray(x)[None, :])[0]

    def spmm(self, x: Any) -> jax.Array:
        return self._run(jnp.asarray(x))
