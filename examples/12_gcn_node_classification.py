"""Graph convolutional network (GCN) node classification on tpusparse.

A 2-layer Kipf-Welling GCN is two SpMMs against a FROZEN sparse operator
(the normalized adjacency) plus two dense matmuls — exactly this
library's op. The pipeline:

1. ``graph.normalized_adjacency``: A_hat = D^-1/2 (A + I) D^-1/2, built
   in O(nnz) from the edge list (never densified).
2. ``auto_format(csr, expect_batch=F)``: statistics-driven routing of the
   operator to the right packed format for batched SpMM.
3. ``autodiff.linear_map``: differentiable ``x @ A_hat`` — the backward
   pass runs through a transpose-packed twin, no nnz-scale gathers.
4. Features live CHANNELS-FIRST ``(F, N)`` so propagation is the library's
   row-batch SpMM and the weight mixes are ``(F_out, F_in) @ (F_in, N)``
   dense matmuls — no transposes anywhere in the training step.

Workload: a stochastic block model with 2 communities, 5% labeled nodes,
semi-supervised cross-entropy. Run: python examples/12_gcn_node_classification.py [--cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--cpu" in sys.argv:
    import jax

    jax.config.update("jax_platforms", "cpu")

import jax
import jax.numpy as jnp
import numpy as np

from tpusparse.autodiff import linear_map
from tpusparse.formats.auto import auto_format
from tpusparse.formats.csr import CsrMatrix
from tpusparse.graph import normalized_adjacency


def stochastic_block_model(n, p_in, p_out, seed=0):
    """Undirected 2-community graph; returns (CsrMatrix, labels)."""
    rng = np.random.default_rng(seed)
    labels = (np.arange(n) >= n // 2).astype(np.int32)
    ii, jj = np.triu_indices(n, k=1)
    same = labels[ii] == labels[jj]
    keep = rng.random(ii.size) < np.where(same, p_in, p_out)
    ii, jj = ii[keep], jj[keep]
    rows = np.concatenate([ii, jj])         # symmetrize
    cols = np.concatenate([jj, ii])
    return CsrMatrix.from_coo(n, n, rows, cols,
                              np.ones(rows.size, np.float32)), labels


def main():
    n, f0, hidden, n_class = 2048, 32, 64, 2
    csr, labels = stochastic_block_model(n, p_in=16 / n, p_out=2 / n)
    a_hat = normalized_adjacency(csr)
    fmt = auto_format(a_hat, expect_batch=max(f0, hidden))
    # Routing note: at F=64-wide batched SpMM the gather formats pay
    # ~F x their own bytes-time in the router's cost model, so even a
    # 0.5%-dense adjacency routes to a
    # dense-tile format here — drop expect_batch and the same matrix
    # routes to a gather format for single-vector SpMV.
    print(f"A_hat: n={n}, nnz={a_hat.nnz} -> {type(fmt).__name__}")
    apply_a = linear_map(fmt, csr=a_hat)    # differentiable H @ A_hat

    rng = np.random.default_rng(1)
    # noisy community-indicator features, channels-first (F0, N)
    h0 = (0.1 * rng.normal(size=(f0, n))
          + 0.3 * (rng.normal(size=(f0, 1)) * (2.0 * labels - 1.0))
          ).astype(np.float32)
    h0 = jnp.asarray(h0)
    y = jnp.asarray(labels)
    train_mask = jnp.asarray(rng.random(n) < 0.05)
    print(f"labeled nodes: {int(train_mask.sum())}/{n}")

    params = {
        "w1": jnp.asarray(rng.normal(size=(hidden, f0)).astype(np.float32)
                          * np.sqrt(2.0 / f0)),
        "w2": jnp.asarray(rng.normal(size=(n_class, hidden)).astype(np.float32)
                          * np.sqrt(2.0 / hidden)),
    }

    def forward(p, h):
        z = jax.nn.relu(p["w1"] @ apply_a(h))     # propagate, then mix
        return p["w2"] @ apply_a(z)               # logits (C, N)

    def loss_fn(p, h):
        logits = forward(p, h)
        logp = jax.nn.log_softmax(logits, axis=0)
        nll = -jnp.take_along_axis(logp, y[None, :], axis=0)[0]
        return jnp.where(train_mask, nll, 0.0).sum() / train_mask.sum()

    @jax.jit
    def step(p, h):
        loss, grads = jax.value_and_grad(loss_fn)(p, h)
        return loss, jax.tree.map(lambda w, g: w - 0.5 * g, p, grads)

    @jax.jit
    def accuracy(p, h):
        return (jnp.argmax(forward(p, h), axis=0) == y).mean()

    print(f"init: loss={float(loss_fn(params, h0)):.3f} "
          f"acc={float(accuracy(params, h0)):.3f}")
    for it in range(1, 61):
        loss, params = step(params, h0)
        if it % 20 == 0:
            print(f"step {it:3d}: loss={float(loss):.4f} "
                  f"acc(all nodes)={float(accuracy(params, h0)):.3f}")


if __name__ == "__main__":
    main()
