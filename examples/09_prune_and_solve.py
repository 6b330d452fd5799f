"""Pruning a trained dense weight + solving a sparse linear system.

Two production workflows the kernel benchmark feeds:

1. PRUNE: a trained dense weight enters, a packed sparse layer leaves.
   ``nm_prune`` (N:M structured along the contraction axis) is the
   SELL-shaped choice — with M dividing the 128-row window, the SELL pack
   has ZERO padding and a uniform width (prune.summary shows it).

2. SOLVE: conjugate gradient on an SPD system, where solver wall-clock
   is iterations x the format's measured SpMV time. The 5-point Laplacian
   at 4096 unknowns is ~0.12% dense: SELL streams ~800x fewer bytes than
   a dense matmul here.

Run: python examples/09_prune_and_solve.py [--cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--cpu" in sys.argv:
    import jax

    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from tpusparse import magnitude_prune, nm_prune
from tpusparse.formats.csr import CsrMatrix
from tpusparse.formats.sell import SellMatrix
from tpusparse.prune import summary
from tpusparse.solve import cg


def laplacian_2d(side: int) -> CsrMatrix:
    """SPD 5-point Laplacian on a side x side grid, built as COO (never
    densified)."""
    n = side * side
    idx = np.arange(n).reshape(side, side)
    rows = [np.arange(n)]
    cols = [np.arange(n)]
    vals = [np.full(n, 4.0, np.float32)]
    for (di, dj) in ((0, 1), (1, 0)):
        src = idx[: side - di, : side - dj].ravel()
        dst = idx[di:, dj:].ravel()
        for (r, c) in ((src, dst), (dst, src)):
            rows.append(r)
            cols.append(c)
            vals.append(np.full(r.size, -1.0, np.float32))
    return CsrMatrix.from_coo(n, n, np.concatenate(rows),
                              np.concatenate(cols), np.concatenate(vals))


def main():
    # --- 1. prune a "trained" dense weight --------------------------------
    rng = np.random.default_rng(0)
    w = rng.normal(size=(1024, 512)).astype(np.float32)

    for name, csr in [
        ("magnitude 25% (per-column)", magnitude_prune(w, 0.25)),
        ("2:4 structured", nm_prune(w, 2, 4)),
    ]:
        info = summary(csr)
        print(f"{name}: density {info['density']:.2f}, SELL W "
              f"{info['sell_w']}, padding {info['sell_pad_frac'] * 100:.1f}%")
        s = SellMatrix.from_csr(csr)
        x = jnp.asarray(rng.normal(size=1024).astype(np.float32))
        y = s.spmv(x)
        ref = np.asarray(x, np.float64) @ csr.to_dense().astype(np.float64)
        err = float(np.abs(np.asarray(y) - ref).max())
        print(f"  spmv max|err| vs float64: {err:.2e}")

    # --- 2. CG on a sparse SPD system --------------------------------------
    side = 64                       # 4096 unknowns
    lap = laplacian_2d(side)
    s = SellMatrix.from_csr(lap)    # symmetric: spmv(v) = L v
    print(f"\nLaplacian {lap.shape}, nnz {lap.nnz} "
          f"(density {lap.nnz / (side ** 4) * 100:.2f}%)")
    z_true = rng.normal(size=side * side).astype(np.float32)
    b = jnp.asarray(s.spmv(jnp.asarray(z_true)))
    z, info = cg(s, b, tol=1e-5)
    print(f"CG: {int(info['iters'])} iters, relative residual "
          f"{float(info['resnorm']) / float(jnp.linalg.norm(b)):.2e}, "
          f"max|z - z_true| = {float(jnp.abs(z - z_true).max()):.2e}")


if __name__ == "__main__":
    main()
