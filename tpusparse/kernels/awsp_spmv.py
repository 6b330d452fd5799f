"""AWSP in plain XLA: weight-compressed SELL + activation window-group skip.

The reference's flagship kernels (awsp.cu:5-317, awsp_ref.cu:6-185) exploit
BOTH sparsities at once: weight sparsity via packed A values and activation
sparsity via skipping work where the broadcast x is zero (awsp.cu:95-107).
Here:

- weight sparsity: the SELL layout (converter-ranked int8 indices + padded
  values, see sell_spmv.py) — bytes scale with nnz(A);
- activation sparsity: a plan of the ``G x 128``-row window groups where X
  has a survivor. Only those groups are taken from the packed arrays and
  reduced, so bytes scale with nnz(A restricted to active groups).

Zero-group trick: vals/idx carry one extra all-zero window group at group
index ``ng`` and X is padded with a matching zero group. An empty plan points
there, and the device-side plan (``awsp_spmm_dynamic``) fills its inactive
tail with it: the plan keeps one static length, so one compile serves every
activation pattern, and the tail's products with the all-zero group add
nothing to the result (they still cost their gather and reduction).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tpusparse.kernels.sell_spmv import gather_reduce, window_src

_LANES = 128


@functools.partial(jax.jit, static_argnames=("g",))
def awsp_spmm_padded(
    win: jax.Array,      # (na,) int32 active-group ids; pads point at ng
    idx: jax.Array,      # (nb, (ng + 1) * G, W, 128) int8 — last group zero
    vals: jax.Array,     # (nb, (ng + 1) * G, W, 128) — last group zero
    x: jax.Array,        # (B, (ng + 1) * G * 128) — last group zero
    *,
    g: int,
) -> jax.Array:          # (B, N_padded)
    nb = vals.shape[0]
    windows = (win.astype(jnp.int32)[:, None] * g
               + jnp.arange(g, dtype=jnp.int32)).reshape(-1)
    src = window_src(jnp.take(idx, windows, axis=1), windows)
    y = gather_reduce(src, jnp.take(vals, windows, axis=1), x, axes=(1, 2))
    return y.reshape(nb * _LANES, -1).T.astype(x.dtype)


def device_group_plan(x: jax.Array, ng: int, span: int) -> jax.Array:
    """Device-side activation plan: the (ng,) active group ids in
    ascending order, the inactive tail set to the zero group ``ng``. The
    skip decision the reference makes per element in-kernel
    (asp.cu:20-27), made per group by XLA with no host round-trip."""
    rows = ng * span
    act = (x[:, :rows] != 0).reshape(x.shape[0], ng, span).any(axis=(0, 2))
    return jnp.nonzero(act, size=ng, fill_value=ng)[0].astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("g",))
def awsp_spmm_dynamic(
    idx: jax.Array,      # (nb, (ng + 1) * G, W, 128) int8 — last group zero
    vals: jax.Array,     # (nb, (ng + 1) * G, W, 128) — last group zero
    x: jax.Array,        # (B, (ng + 1) * G * 128) — last group zero
    *,
    g: int,
) -> jax.Array:          # (B, N_padded)
    """Zero-host-cost activation skip: the plan is computed on device
    (``device_group_plan``); one compile serves every activation pattern
    of this layout."""
    ng = vals.shape[1] // g - 1
    plan = device_group_plan(x, ng, g * _LANES)
    return awsp_spmm_padded(plan, idx, vals, x, g=g)
