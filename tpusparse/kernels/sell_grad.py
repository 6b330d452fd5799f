"""Closed-form SELL value-gradient in plain XLA.

For the linear map y = x @ A with A SELL-packed, the exact value cotangent
is per-slot:  dvals[j,t,s,r] = sum_b x_b[t*128 + idx[j,t,s,r]] * g_b[j*128+r]
— the same in-window gather the forward product uses (sell_spmv.py),
followed by an elementwise multiply that XLA fuses with it, so the gradient
streams the index plane once and writes the value plane once.

Pad slots are marked with index -1 (``idx_signed``) so their cotangent is
zeroed without a mask array; real slots carry the usual 0..127 in-window
offset.

No reference counterpart (the reference is inference-only); this is what
makes sparse-weight training (autodiff.trainable_linear) run at the
format's byte rate.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpusparse.kernels.sell_spmv import window_src

_LANES = 128


@jax.jit
def sell_dvals_padded(
    idx_signed: jax.Array,   # (nb, nt, W, 128) int8; -1 marks pad slots
    x: jax.Array,            # (B, M_padded)
    g: jax.Array,            # (B, N_padded) — output cotangent
) -> jax.Array:              # (nb, nt, W, 128) fp32
    nb, nt = idx_signed.shape[0], idx_signed.shape[1]
    src = window_src(jnp.maximum(idx_signed, 0), jnp.arange(nt))
    xg = jnp.take(x.T, src, axis=0, mode="clip")        # (nb, nt, W, 128, B)
    gj = g.T.reshape(nb, 1, 1, _LANES, -1)              # (nb, 1, 1, 128, B)
    dv = jnp.sum(xg * gj, axis=-1, dtype=jnp.float32)
    return jnp.where(idx_signed >= 0, dv, 0.0)
