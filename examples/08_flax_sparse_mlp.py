"""A Flax MLP whose hidden layer is a pruned sparse matrix.

SparseLinear (tpusparse/nn.py) drops into a linen model like any other
module: its packed twin-layout values are ordinary flax params, so the
standard optax train loop below needs nothing sparse-aware. The sparse
layer's forward AND backward stream the packed format — at 90% weight
sparsity several times fewer bytes than a dense hidden layer each step.

Run: python examples/08_flax_sparse_mlp.py [--cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--cpu" in sys.argv:
    import jax

    jax.config.update("jax_platforms", "cpu")

import flax.linen as fl_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax

from tpusparse.nn import SparseLinear
from tpusparse.testing import generators


def main():
    d_in, d_hidden, d_out = 512, 1024, 64
    # a 90%-pruned hidden weight: the mask is frozen, the values train
    a0 = generators.random_sparse_matrix(d_in, d_hidden, density=0.1, seed=0)
    SparseHidden = SparseLinear.from_dense(a0, use_bias=True,
                                           activation=jax.nn.relu)

    class Mlp(fl_nn.Module):
        @fl_nn.compact
        def __call__(self, x):
            h = SparseHidden()(x)                       # sparse, packed path
            return fl_nn.Dense(d_out)(h)                # small dense head

    rng = np.random.default_rng(0)
    xs = jnp.asarray(generators.random_sparse_batch(64, d_in, density=0.5,
                                                    seed=1))
    w_true = jnp.asarray(rng.standard_normal((d_in, d_out)) * 0.05,
                         dtype=jnp.float32)
    ys = jnp.tanh(xs @ w_true)

    model = Mlp()
    variables = model.init(jax.random.PRNGKey(0), xs)
    tx = optax.adam(1e-2)
    params = variables["params"]
    opt_state = tx.init(params)

    @jax.jit
    def train_step(p, s):
        def loss_fn(pp):
            return jnp.mean((model.apply({"params": pp}, xs) - ys) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, s = tx.update(grads, s, p)
        return loss, optax.apply_updates(p, updates), s

    for i in range(40):
        loss, params, opt_state = train_step(params, opt_state)
        if i % 10 == 0 or i == 39:
            print(f"step {i:3d}: mse {float(loss):.5f}")

    masks = SparseHidden.masks
    sp = params["SparseLinear_0"]
    off = float(jnp.abs(jnp.where(masks["vals"], 0.0, sp["vals"])).max())
    print(f"hidden layer stays pruned: max |pad slot| = {off:.1e}")


if __name__ == "__main__":
    main()
