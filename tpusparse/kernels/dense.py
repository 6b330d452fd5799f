"""Dense baselines: ``Y = X @ A`` with dense A.

``dense_xla`` is the counterpart of the reference's cuBLAS baseline
(cublas.cu:33): XLA hands the product to cuBLAS. It accepts X as (M,)
(SpMV) or (B, M) (SpMM) and is the correctness anchor and the performance
bar every sparse format must beat on its own bytes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


# fp32 matmuls may run in TF32 by default (~1e-3 relative error per term,
# which busts the reference's 1e-3 tolerance, tester.cpp:75, at 4096 terms);
# HIGHEST keeps full fp32. GEMV is memory-bound, so the extra passes are
# free in wall-clock.
_PRECISION = jax.lax.Precision.HIGHEST


@jax.jit
def dense_xla(a: jax.Array, x: jax.Array) -> jax.Array:
    """XLA dense baseline. x: (m,) or (b, m); a: (m, n)."""
    squeeze = x.ndim == 1
    xb = x[None, :] if squeeze else x
    y = jnp.dot(xb, a, preferred_element_type=jnp.float32,
                precision=_PRECISION).astype(a.dtype)
    return y[0] if squeeze else y

