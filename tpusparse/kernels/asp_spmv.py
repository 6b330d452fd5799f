"""Activation-sparse SpMV/SpMM over dense A ("ASP"), in plain XLA.

The reference's ASP family keeps A fully dense (reordered into blocks,
asp.cpp:5-13) and skips multiply-accumulates whenever the broadcast x value
is zero (``cur_x == 0`` skip, asp.cu:20-27).

Here X-sparsity is exploited at the granularity of whole 128-element
m-windows: a plan lists the windows where X has any nonzero, the active
128-row windows of dense A are gathered, and one ``jnp.dot`` at HIGHEST
precision (a cuBLAS call) multiplies them. Traffic and FLOPs scale with the
number of active windows: no saving on i.i.d. random X (every window has
survivors), proportional savings on structured activations (ReLU blocks,
MoE routing, padded batches). A plan that covers every window skips the
gather and multiplies A as it is stored.

A and X are padded with one extra all-zero window; the device-side plan
fills its inactive tail with it, so padded entries contribute nothing.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from tpusparse.utils import round_up

_LANES = 128


def _dot(x, a):
    return jnp.dot(x, a, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST).astype(a.dtype)


@jax.jit
def _asp_call(win_ids, x_pad, a_pad):
    """``x @ A`` over the windows ``win_ids`` of A only."""
    b, np_ = x_pad.shape[0], a_pad.shape[1]
    a_w = jnp.take(a_pad.reshape(-1, _LANES, np_), win_ids, axis=0)
    x_w = jnp.take(x_pad.reshape(b, -1, _LANES), win_ids, axis=1)
    return _dot(x_w.reshape(b, -1), a_w.reshape(-1, np_))


@jax.jit
def _asp_call_dense(x_pad, a_pad):
    """The plan covers every window: multiply A as stored."""
    return _dot(x_pad, a_pad)


@jax.jit
def _asp_call_dynamic(x_pad, a_pad):
    """Zero-host-cost window skip: the plan is computed on device (see
    kernels/awsp_spmv.py device_group_plan, here at window granularity).
    One compile serves every activation pattern — the XLA form of the
    reference's per-call ``cur_x == 0`` skip (asp.cu:20-27)."""
    from tpusparse.kernels.awsp_spmv import device_group_plan

    nt = a_pad.shape[0] // _LANES - 1            # real windows
    return _asp_call(device_group_plan(x_pad, nt, _LANES), x_pad, a_pad)


@jax.tree_util.register_pytree_node_class
class AspMatrix:
    """Dense A prepared for window-skip activation-sparse products."""

    def __init__(self, a_pad, shape, block_n: int):
        self.a_pad = a_pad            # (Mp + 128, Np): trailing zero window
        self.shape = shape
        self.block_n = block_n

    def tree_flatten(self):
        return (self.a_pad,), (self.shape, self.block_n)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], *aux)

    @classmethod
    def _io_rebuild(cls, aux, leaves):
        """Rebuild from npz leaves (formats/io.py hook)."""
        if len(leaves) != 1:
            raise ValueError(f"{len(leaves)} leaves, expected 1")
        return cls.tree_unflatten(aux, (leaves[0],))

    def __repr__(self) -> str:
        return (f"AspMatrix(shape={self.shape}, block_n={self.block_n}, "
                f"dense {self.device_bytes() / 1e6:.1f} MB + window-skip "
                f"plans)")

    @classmethod
    def from_dense(cls, a: np.ndarray, block_n: int = 2048) -> "AspMatrix":
        """``block_n``: the column padding quantum of the stored array."""
        a = np.asarray(a)
        m, n = a.shape
        mp, np_ = round_up(m, _LANES), round_up(n, block_n)
        a_pad = np.zeros((mp + _LANES, np_), a.dtype)   # extra zero window
        a_pad[:m, :n] = a
        return cls(a_pad, (m, n), block_n)

    @classmethod
    def from_csr(cls, csr, block_n: int = 2048) -> "AspMatrix":
        """ASP's format IS a (padded) dense array (the reference stores all
        M*N values too, asp.cpp:5-13), so this necessarily materializes
        (m, n) memory — it exists so ``auto_format`` can route >60%-dense
        CSR input (where CSR triplets already outweigh dense) without a
        special case."""
        return cls.from_dense(csr.to_dense(), block_n=block_n)

    def device_bytes(self) -> int:
        a = self.a_pad
        return int(np.prod(a.shape)) * a.dtype.itemsize

    def to_dense(self) -> np.ndarray:
        return np.asarray(self.a_pad)[:self.shape[0], :self.shape[1]]

    def plan(self, x: np.ndarray) -> np.ndarray:
        """Active-window ids for this activation, padded with the zero window."""
        x = np.asarray(x)
        m = self.shape[0]
        mp = self.a_pad.shape[0] - _LANES
        nt = mp // _LANES
        xw = np.zeros(mp, dtype=bool)
        flat = x.reshape(-1, x.shape[-1]) if x.ndim > 1 else x[None, :]
        xw[:m] = (flat != 0).any(axis=0)
        active = np.nonzero(xw.reshape(nt, _LANES).any(axis=1))[0]
        if active.size == 0:
            active = np.array([nt])                     # only the zero window
        return active.astype(np.int32)

    def _full_plan(self) -> np.ndarray:
        """Every window — the degenerate plan used under jit tracing."""
        nt = (self.a_pad.shape[0] - _LANES) // _LANES
        return np.arange(nt, dtype=np.int32)

    def _run(self, x2d, plan=None) -> jax.Array:
        xj = jnp.asarray(x2d)
        b = xj.shape[0]
        mp_tot = self.a_pad.shape[0]
        xp = jnp.pad(xj, ((0, 0), (0, mp_tot - xj.shape[1])))
        a = jnp.asarray(self.a_pad)
        if (plan is None and isinstance(xj, jax.core.Tracer)) \
                or (isinstance(plan, str) and plan == "device"):
            # device-side dynamic skip (see _asp_call_dynamic): no host
            # round-trip, one compile for every activation pattern
            y = _asp_call_dynamic(xp, a)
        else:
            win = self.plan(np.asarray(x2d)) if plan is None \
                else np.asarray(plan)
            if win.size == mp_tot // _LANES - 1:      # every window active
                y = _asp_call_dense(xp, a)
            else:
                y = _asp_call(jnp.asarray(win), xp, a)
        return y[:b, :self.shape[1]]

    def spmv(self, x, plan=None) -> jax.Array:
        """``plan``: None (host-exact plan for concrete x, device-dynamic
        under jit tracing), a precomputed ``self.plan(x)`` array, or
        ``"device"`` to force the dynamic path."""
        return self._run(jnp.asarray(x)[None, :], plan=plan)[0]

    def spmm(self, x, plan=None) -> jax.Array:
        return self._run(jnp.asarray(x), plan=plan)
