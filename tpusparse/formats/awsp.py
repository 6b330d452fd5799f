"""AWSP: SELL weight compression + activation window-group-skip plan.

The counterpart of the reference's combined weight+activation-sparse
formats (`AWSPMatrix`, awsp.cpp:3-65; `AWSPRefMatrix`, awsp_ref.cpp:4-78):
A is packed once with the SELL converter (bytes ∝ nnz(A)); each product
call reduces only the G·128-row m-window groups where X has any nonzero
(kernels/awsp_spmv.py). The plan of active groups comes from one of two
paths:

- concrete X (or an explicit ``plan=``): an O(M) host-side exact-sized
  plan — a static operand, one compile per distinct active-count;
- under jit tracing (serving loops): the DEVICE-side dynamic path — the
  activity mask and the compacted id list are XLA ops, padded to the group
  count with the zero group. Zero host cost, one compile for every
  activation pattern — the reference's per-call x==0 skip
  (awsp.cu:95-107) without its per-element overhead.

Padding convention: the window axis is padded to a multiple of G, then one
extra all-zero GROUP is appended (group index ``ng``); plan padding and
empty-X both point there.
"""

from __future__ import annotations

from typing import Any

import numpy as np

import jax
import jax.numpy as jnp

from tpusparse.formats.sell import sell_pack
from tpusparse.utils import round_up

_LANES = 128
_SUB = 8

@jax.tree_util.register_pytree_node_class
class AwspMatrix:
    def __init__(self, idx: Any, vals: Any, shape, padded, w: int, g: int,
                 nnz: int):
        self.idx = idx              # (nb, (ng+1)*G, W, 128) int8
        self.vals = vals            # (nb, (ng+1)*G, W, 128)
        self.shape = shape
        self.padded = padded        # (mp, np) BEFORE group padding
        self.w = w
        self.g = g                  # windows per skippable group
        self.nnz = nnz

    def tree_flatten(self):
        return ((self.idx, self.vals),
                (self.shape, self.padded, self.w, self.g, self.nnz))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @classmethod
    def _io_rebuild(cls, aux, leaves):
        """Rebuild from npz leaves (formats/io.py hook)."""
        if len(leaves) != 2:
            raise ValueError(f"{len(leaves)} leaves, expected 2")
        return cls.tree_unflatten(aux, tuple(leaves))

    @classmethod
    def _from_pack(cls, p: dict, g: int) -> "AwspMatrix":
        idx, vals = p["idx"], p["vals"]
        nt = vals.shape[1]
        extra = round_up(nt, g) - nt + g        # align to G + 1 zero group
        zpad = ((0, 0), (0, extra), (0, 0), (0, 0))
        return cls(np.pad(idx, zpad), np.pad(vals, zpad), p["shape"],
                   p["padded"], p["w"], g, p["nnz"])

    def __repr__(self) -> str:
        return (f"AwspMatrix(shape={self.shape}, nnz={self.nnz}, "
                f"w={self.w}, g={self.g}, groups={self._ng}, "
                f"{self.device_bytes() / 1e6:.1f} MB)")

    @classmethod
    def from_dense(cls, a: np.ndarray, w: int | None = None,
                   g: int = 1, dtype: Any = None) -> "AwspMatrix":
        """``g``: windows per skippable group (skip granularity g*128 rows).
        Default 1 — per-window skip, the finest the layout admits; a
        coarser g trades skip resolution for fewer, larger groups.
        ``dtype``: bf16 value storage, same trade as
        SellMatrix.from_dense. Reference granularity target: the per-
        32-element word skip of asp.cu:20-27."""
        return cls._from_pack(sell_pack(a, w=w, dtype=dtype), g)

    @classmethod
    def from_csr(cls, csr, w: int | None = None, g: int = 1) -> "AwspMatrix":
        """Pack from ``CsrMatrix`` without materializing dense A."""
        from tpusparse.formats.sell import sell_pack_csr

        return cls._from_pack(sell_pack_csr(csr, w=w), g)

    @property
    def n_groups(self) -> int:
        """Number of real (non-padding) window groups."""
        return self.vals.shape[1] // self.g - 1

    # internal alias kept for brevity in this module
    _ng = n_groups

    def device_bytes(self, x: np.ndarray | None = None) -> int:
        """Bytes the kernel streams: all groups, or only X-active ones."""
        vals = self.vals
        nb, _, wd, lanes = vals.shape
        na = self._ng if x is None else len(self.plan(np.asarray(x)))
        return nb * na * self.g * wd * lanes * (vals.dtype.itemsize + 1)

    def to_dense(self) -> np.ndarray:
        from tpusparse.formats.sell import SellMatrix

        nt = self.padded[0] // _LANES
        idx = np.asarray(self.idx)[:, :nt]
        vals = np.asarray(self.vals)[:, :nt]
        return SellMatrix(idx, vals, self.shape, self.padded, self.w,
                          self.nnz).to_dense()

    def plan(self, x2d: np.ndarray) -> np.ndarray:
        """Active-group ids for this activation (the zero group if none).

        Exact-sized: one compile per distinct active-count, which is
        bounded by the group count and cached.
        """
        x2d = np.asarray(x2d)
        if x2d.ndim == 1:
            x2d = x2d[None, :]
        m = self.shape[0]
        ng = self._ng
        rows = ng * self.g * _LANES
        xw = np.zeros(rows, dtype=bool)
        xw[:m] = (x2d[:, :m] != 0).any(axis=0)
        active = np.nonzero(xw.reshape(ng, self.g * _LANES).any(axis=1))[0]
        if active.size == 0:
            active = np.array([ng])
        return active.astype(np.int32)

    def _full_plan(self) -> np.ndarray:
        """Every group — the degenerate plan used under jit tracing."""
        return np.arange(self._ng, dtype=np.int32)

    def _run(self, x2d: Any, plan: Any = None):
        from tpusparse.kernels.awsp_spmv import (awsp_spmm_dynamic,
                                                 awsp_spmm_padded)

        xj = jnp.asarray(x2d)
        rows_tot = self.vals.shape[1] * _LANES   # incl. group padding + zero
        xp = jnp.pad(xj, ((0, 0), (0, rows_tot - xj.shape[1])))
        if (plan is None and isinstance(xj, jax.core.Tracer)) \
                or (isinstance(plan, str) and plan == "device"):
            # zero-host-cost dynamic skip: the activity mask and the
            # compacted plan are computed on device (kernels/awsp_spmv.py)
            # — one compile serves every activation pattern, matching the
            # reference's per-call x==0 skip (awsp.cu:95-107) with no host
            # round-trip.
            out = awsp_spmm_dynamic(self.idx, self.vals, xp, g=self.g)
            return out[:, :self.shape[1]]
        if plan is None:
            plan = self.plan(np.asarray(x2d))
        out = awsp_spmm_padded(jnp.asarray(plan), self.idx, self.vals,
                               xp, g=self.g)
        return out[:, :self.shape[1]]

    def spmv(self, x: Any, plan: Any = None) -> jax.Array:
        """``plan``: None (host-exact plan for concrete x, device-dynamic
        under jit tracing), a precomputed ``self.plan(x)`` array, or
        ``"device"`` to force the dynamic path."""
        return self._run(jnp.asarray(x)[None, :], plan=plan)[0]

    def spmm(self, x: Any, plan: Any = None) -> jax.Array:
        return self._run(jnp.asarray(x), plan=plan)
