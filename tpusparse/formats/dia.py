"""DIA: diagonal-offset storage for banded matrices.

Motivation: a 1M-unknown 5-point Laplacian routed to tile formats pays the
(8, 128) chunk quantum on every one of ~41k touched tiles — 210 MB stored
for 26 MB of payload. Banded structure is not tile-shaped; it is
SHIFT-shaped:

    y[c] = sum_d  vals_d[c] * x[c + d]        (d = m_index - out_index)

so the carrier is k dense diagonal arrays and k statically shifted
elementwise multiply-adds — streams that XLA fuses into one loop fusion,
no gathers, no tiles. Bytes = k*n*4 regardless
of where the band sits. The reference has no banded format (its tester is
uniform-random, tester.cpp:106); this closes the gap the solver bench
exposed, and `auto_format` routes to it whenever the diagonal count is
small enough that DIA bytes undercut the slot formats.

Offsets are STATIC (pytree aux, a tuple of ints): each diagonal's shift
becomes a trace-time `lax.slice`, so `jit` sees fixed shapes and the
whole SpMV lowers to one fused elementwise loop.

Unlike the gather formats (which need `autodiff.linear_map`'s custom
VJPs), DIA is natively differentiable: slices/pads have built-in
adjoints, so `jax.grad` flows through d/dx AND d/dvals (trainable
banded operators) at full fused speed (tests/test_dia.py).
"""

from __future__ import annotations

from typing import Any

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax


def dia_pack_csr(csr, max_diags: int = 512,
                 symmetric: bool | str = "auto") -> dict[str, Any]:
    """Pack from ``CsrMatrix`` (CSR of A.T) in O(nnz + k*n).

    Raises if the matrix touches more than ``max_diags`` distinct
    diagonals — DIA on scattered structure stores mostly zeros and the
    per-diagonal unrolled loop would bloat the jit; route such matrices
    elsewhere (`auto_format` checks before packing).

    ``symmetric="auto"`` (default) detects BITWISE-symmetric square
    operators and keeps only the ``d >= 0`` diagonals — the mirror
    ``vals_{-d}[c] = vals_d[c-d]`` is reconstructed at apply time from
    the SAME array at a shifted offset. This nearly halves memory
    traffic, not just capacity: XLA fuses all terms into one pass, and
    both offset reads of ``vals_d`` hit the same cache lines (as the k
    offset-reads of ``x`` do). Symmetric operators are the
    iterative-solver common case (CG/AMG require them). ``False`` forces full storage;
    ``True`` asserts symmetry and raises if it does not hold bitwise.
    """
    m, n = csr.shape
    r = np.repeat(np.arange(n, dtype=np.int64), csr.row_nnz)
    mi = csr.col_idx.astype(np.int64)
    d = mi - r
    offsets = np.unique(d)
    if offsets.size > max_diags:
        raise ValueError(
            f"{offsets.size} distinct diagonals > max_diags={max_diags}; "
            "DIA suits banded matrices — use auto_format for routing")
    vals = np.zeros((max(offsets.size, 1), n), dtype=np.float32)
    if d.size:
        slot = np.searchsorted(offsets, d)
        # duplicates sum, matching every other packer
        np.add.at(vals, (slot, r), csr.values.astype(np.float32))

    sym = False
    if symmetric and m == n:
        if not offsets.size:
            sym = True                   # empty operator: trivially sym
        else:
            neg = offsets[offsets < 0]
            pos = set(int(v) for v in offsets[offsets > 0])
            mirrored = all(-int(v) in pos for v in neg) and \
                len(neg) == len(pos)
            if mirrored:
                off_l = [int(v) for v in offsets]
                sym = all(
                    np.array_equal(vals[off_l.index(-dd)][dd:],
                                   vals[off_l.index(dd)][:n - dd])
                    and not vals[off_l.index(-dd)][:dd].any()
                    for dd in sorted(pos))
            if sym:
                keep = offsets >= 0
                offsets = offsets[keep]
                vals = vals[keep]
    if symmetric is True and not sym:
        raise ValueError(
            "symmetric=True but the matrix is not square bitwise-"
            "symmetric in DIA layout" if m == n else
            f"symmetric=True needs a square operator, got {m}x{n}")
    return dict(offsets=tuple(int(v) for v in offsets), vals=vals,
                shape=(m, n), nnz=int(csr.nnz), sym=sym)


@jax.tree_util.register_pytree_node_class
class DiaMatrix:
    """k diagonals of A as (k, n) dense rows; ``offsets[i] = m_idx - out_idx``.

    ``sym=True``: only ``d >= 0`` diagonals are stored (square bitwise-
    symmetric operators); the ``-d`` mirror is the same array read at a
    shifted offset, ``vals_{-d}[c] = vals_d[c-d]`` — near-half the memory
    traffic for the solver-stack common case (see ``dia_pack_csr``).
    """

    def __init__(self, offsets: tuple, vals: Any, shape, nnz: int,
                 sym: bool = False):
        self.offsets = tuple(offsets)   # static: aux data, hashable
        self.vals = vals                # (k, n) fp32
        self.shape = shape
        self.nnz = nnz
        self.sym = bool(sym)

    def tree_flatten(self):
        return ((self.vals,), (self.offsets, self.shape, self.nnz,
                               self.sym))

    @classmethod
    def tree_unflatten(cls, aux, children):
        (vals,) = children
        return cls(aux[0], vals, *aux[1:4])

    @classmethod
    def _io_rebuild(cls, aux, leaves):
        if len(leaves) != 1:
            raise ValueError(f"{len(leaves)} leaves, expected 1")
        # len-3 aux: files saved before the sym field; a fifth entry (a
        # retired lowering switch) is ignored
        return cls.tree_unflatten(tuple(aux), leaves)

    def __repr__(self) -> str:
        return (f"DiaMatrix(shape={self.shape}, nnz={self.nnz}, "
                f"diags={len(self.offsets)}{'|sym' if self.sym else ''}, "
                f"{self.device_bytes() / 1e6:.1f} MB)")

    @classmethod
    def from_csr(cls, csr, max_diags: int = 512,
                 symmetric: bool | str = "auto") -> "DiaMatrix":
        return cls(**dia_pack_csr(csr, max_diags=max_diags,
                                  symmetric=symmetric))

    @classmethod
    def from_dense(cls, a: np.ndarray, max_diags: int = 512,
                   symmetric: bool | str = "auto") -> "DiaMatrix":
        from tpusparse.formats.csr import CsrMatrix

        return cls.from_csr(CsrMatrix.from_dense(np.asarray(a)),
                            max_diags=max_diags, symmetric=symmetric)

    def device_bytes(self) -> int:
        return int(np.prod(self.vals.shape)) * 4

    def desym(self) -> "DiaMatrix":
        """Materialize full storage from symmetric storage (no-op when
        already full). The mirror row is ``vals_{-d}[c] = vals_d[c-d]``;
        diagonal arrays are small, so the 2x cost is cheap — used by
        sharded paths when the mirror would reach past the immediate
        neighbor slab (``dmax > n_loc``)."""
        if not self.sym:
            return self
        vals = jnp.asarray(self.vals)
        rows = {d: vals[i] for i, d in enumerate(self.offsets)}
        for i, d in enumerate(self.offsets):
            if d > 0:
                rows[-d] = lax.pad(vals[i], jnp.float32(0), ((d, -d, 0),))
        offs = sorted(rows)
        return DiaMatrix(tuple(offs), jnp.stack([rows[d] for d in offs]),
                         self.shape, self.nnz, sym=False)

    def to_dense(self) -> np.ndarray:
        m, n = self.shape
        a = np.zeros((m, n), dtype=np.float32)
        vals = np.asarray(self.vals)
        for i, d in enumerate(self.offsets):
            c = np.arange(max(0, -d), min(n, m - d), dtype=np.int64)
            a[c + d, c] = vals[i, c]
            if self.sym and d > 0:
                a[c, c + d] = vals[i, c]
        return a

    def _x_pad(self) -> tuple[int, int]:
        m, n = self.shape
        dmin = min(self.offsets) if self.offsets else 0
        dmax = max(self.offsets) if self.offsets else 0
        if self.sym:
            dmin = min(dmin, -dmax)
        return max(0, -dmin), max(0, dmax + n - m)

    def spmv(self, x: Any) -> jax.Array:
        """y = x @ A: k statically-shifted multiply-adds, which XLA fuses
        into one loop."""
        x = jnp.asarray(x)
        if x.ndim != 1:
            return self.spmm(x)
        m, n = self.shape
        lo, hi = self._x_pad()
        xp = jnp.pad(x.astype(jnp.float32), (lo, hi))
        y = jnp.zeros(n, jnp.float32)
        for i, d in enumerate(self.offsets):
            y = y + self.vals[i] * lax.slice(xp, (d + lo,), (d + lo + n,))
            if self.sym and d > 0:
                # mirror diagonal -d: vals_d shifted right by d
                vp = lax.pad(self.vals[i], jnp.float32(0),
                             ((d, -d, 0),))
                y = y + vp * lax.slice(xp, (lo - d,), (lo - d + n,))
        return y

    def spmm(self, x: Any) -> jax.Array:
        x = jnp.asarray(x)
        m, n = self.shape
        lo, hi = self._x_pad()
        xp = jnp.pad(x.astype(jnp.float32), ((0, 0), (lo, hi)))
        y = jnp.zeros((x.shape[0], n), jnp.float32)
        for i, d in enumerate(self.offsets):
            y = y + self.vals[i][None, :] * lax.slice(
                xp, (0, d + lo), (x.shape[0], d + lo + n))
            if self.sym and d > 0:
                vp = lax.pad(self.vals[i], jnp.float32(0),
                             ((d, -d, 0),))
                y = y + vp[None, :] * lax.slice(
                    xp, (0, lo - d), (x.shape[0], lo - d + n))
        return y
