"""Smoothed-aggregation AMG: precondition CG with a multigrid V-cycle.

The full pipeline on a 2-D Poisson problem:

    scipy stencil -> CsrMatrix -> smoothed_aggregation() hierarchy
    (auto-routed packed formats per level: DIA for the banded fine levels,
    RSELL for the prolongators, dense matmuls below the cutoff)
    -> amg.solve(b)  ==  cg(A, b, m_inv=one V-cycle)

Why multigrid here: plain CG on an n-unknown Laplacian needs O(sqrt(cond))
~ O(side) iterations — 1114 at 512^2 (and fp32 recurrences stagnate well
before tight tolerances) — while AMG-CG needs ~6, independent of n.

Run:  python examples/11_amg_preconditioned_solve.py [--cpu] [--side 256]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--side", type=int, default=128)
    ap.add_argument("--tol", type=float, default=1e-5)
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from scipy import sparse as ssp

    from tpusparse.amg import smoothed_aggregation
    from tpusparse.formats.csr import CsrMatrix
    from tpusparse.solve import cg

    side = args.side
    n = side * side
    t1d = ssp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(side, side))
    a = (ssp.kron(ssp.eye(side), t1d) + ssp.kron(t1d, ssp.eye(side))).tocsr()

    # hierarchy setup is host-side and one-time; the object is a pytree,
    # so every later call is a cached jitted program
    t0 = time.perf_counter()
    amg = smoothed_aggregation(CsrMatrix.from_scipy(a.astype(np.float32)))
    print(f"setup {time.perf_counter() - t0:.2f}s\n  {amg!r}")

    b = np.random.default_rng(0).normal(size=n).astype(np.float32)
    z, info = amg.solve(jnp.asarray(b), tol=args.tol)   # compiles
    t0 = time.perf_counter()
    z, info = amg.solve(jnp.asarray(b), tol=args.tol)
    res = float(info["resnorm"])                        # fetch syncs
    dt = time.perf_counter() - t0
    print(f"AMG-CG: {int(info['iters'])} iters, resnorm {res:.2e}, "
          f"{dt * 1e3:.1f} ms warm")

    _, plain = cg(amg.levels[0].apply_a, jnp.asarray(b), tol=args.tol,
                  maxiter=20 * side)
    print(f"plain CG for the same tolerance: {int(plain['iters'])} iters")
    err = np.abs(a @ np.asarray(z, np.float64) - b).max()
    print(f"max|Az - b| = {err:.2e}  ({'OK' if err < 1e-3 else 'FAIL'})")


if __name__ == "__main__":
    main()
