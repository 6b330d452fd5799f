"""Flax integration: sparse linear layers backed by the packed formats.

``SparseLinear`` is a linen module whose weight is a packed SELL matrix
with a FROZEN sparsity mask and trainable values (the pruned-training
regime, autodiff.trainable_linear): the forward/backward both stream the
packed format, and the twin-layout parameters
live in the module's params pytree, so optax/flax training loops work
unchanged. Apply the returned mask collection to updates that move
parameters without gradients (weight decay etc.) — see trainable_linear.

The reference has no NN-framework story (it is a CUDA kernel benchmark);
this is the JAX-native packaging that makes the measured kernels usable
inside a model definition.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

import jax.numpy as jnp

from tpusparse.formats.csr import CsrMatrix


class SparseLinear:
    """Factory: build a linen module CLASS bound to a packed sparsity
    pattern. Usage:

        Hidden = tpusparse.nn.SparseLinear.from_csr(csr, use_bias=True)
        layer = Hidden()                      # top-level use...
        variables = layer.init(rng, x)        # params: vals, vals_t[, bias]
        y = layer.apply(variables, x)
        masks = Hidden.masks                  # pad-slot masks for the values

        class Mlp(nn.Module):                 # ...or nested: instantiate
            @nn.compact                       # INSIDE compact so flax binds
            def __call__(self, x):            # the submodule
                return nn.Dense(8)(Hidden()(x))

    Returns the class (not an instance) because flax binds submodules at
    instantiation inside the parent's scope; the packing is host-side work
    that happens once here, and the packed layout fixes the param shapes.
    """

    def __new__(cls, *a, **k):  # pragma: no cover - guidance only
        raise TypeError("use SparseLinear.from_csr(csr, ...) or "
                        "SparseLinear.from_dense(a, ...)")

    @staticmethod
    def from_dense(a: np.ndarray, **kw):
        return SparseLinear.from_csr(CsrMatrix.from_dense(np.asarray(a)),
                                     **kw)

    @staticmethod
    def from_csr(csr: CsrMatrix, *, use_bias: bool = False,
                 activation: Callable[[Any], Any] | None = None):
        import flax.linen as fl_nn

        from tpusparse.autodiff import trainable_linear

        apply_fn, params0, masks, resync = trainable_linear(csr)
        n_out = csr.shape[1]

        class _SparseLinear(fl_nn.Module):
            @fl_nn.compact
            def __call__(self, x):
                vals = self.param("vals", lambda rng: params0["vals"])
                vals_t = self.param("vals_t", lambda rng: params0["vals_t"])
                y = apply_fn({"vals": vals, "vals_t": vals_t}, x)
                if use_bias:
                    b = self.param(
                        "bias", lambda rng: jnp.zeros(n_out, jnp.float32))
                    y = y + b
                return activation(y) if activation is not None else y

        def resync_layer(p):
            """resync for the layer's flax param subtree: re-ties vals_t
            from vals and passes every other entry (bias, ...) through."""
            tied = resync({"vals": p["vals"], "vals_t": p["vals_t"]})
            return {**dict(p), **tied}

        # class attributes: linen Module instances are frozen dataclasses,
        # but attribute lookup falls through to the class
        _SparseLinear.masks = masks
        _SparseLinear.resync = staticmethod(resync_layer)
        _SparseLinear.__name__ = "SparseLinear"
        return _SparseLinear
