"""Jittable Lanczos eigensolver over the packed sparse formats.

The reference stops at the SpMV benchmark; after iterative solvers
(``solve.py``) the second canonical consumer is spectral analysis — and the
library already *needs* it internally: ``chebyshev_preconditioner``
(solve.py) takes spectrum bounds, and ``estimate_lmax``'s power iteration
only sees the largest eigenvalue (with unknown undershoot, hence its
``safety`` fudge). Lanczos with full reorthogonalization gives BOTH ends of
the spectrum to Ritz accuracy in one fixed-shape jittable pass of ``ncv``
SpMVs plus two ``(ncv, n)`` matmuls per step — the same accelerator-friendly
CGS2 shape as ``gmres``'s Arnoldi cycle, and one all-reduce per projection
when the operator is sharded.

Operator convention matches ``solve.py``: ``a.spmv(v) == Aᵀ v``; for the
SYMMETRIC matrices Lanczos applies to, that is ``A v``.
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
from jax import lax

from tpusparse.solve import _as_apply


def _hdot(a, b):
    """Matrix product at full fp32 precision (an fp32 matmul may otherwise
    run in TF32 on the GPU, about three decimal digits)."""
    return jnp.matmul(a, b, precision=lax.Precision.HIGHEST)

def lanczos(a: Any, ncv: int, *, v0: jax.Array | None = None,
            n: int | None = None, seed: int = 0):
    """``ncv`` steps of Lanczos with FULL reorthogonalization (CGS2).

    Returns ``(t, v_basis)``: ``t`` the symmetrized ``(ncv, ncv)``
    projection ``V A Vᵀ`` (tridiagonal up to rounding — full reorth keeps
    it numerically so, where three-term Lanczos famously loses
    orthogonality and ghosts eigenvalues), and ``v_basis`` the ``(ncv, n)``
    orthonormal basis. Exact breakdown (invariant subspace found) zeroes
    the remaining basis rows, exactly like ``gmres``'s Arnoldi.
    Fully jittable: fixed shapes, ``lax.fori_loop``.
    """
    apply = _as_apply(a)
    if n is None:
        if v0 is not None:
            n = v0.shape[-1]
        else:
            n = a.shape[1]
    if v0 is None:
        v0 = jax.random.normal(jax.random.PRNGKey(seed), (n,), jnp.float32)
    v0 = jnp.asarray(v0, jnp.float32)
    tiny = jnp.float32(1e-30)

    v_basis = jnp.zeros((ncv + 1, n), jnp.float32)
    v_basis = v_basis.at[0].set(
        v0 / jnp.maximum(jnp.sqrt(jnp.sum(v0 * v0)), tiny))
    h = jnp.zeros((ncv + 1, ncv), jnp.float32)

    def step(j, carry):
        v_basis, h = carry
        w = apply(v_basis[j]).astype(jnp.float32)
        # CGS2: rows past j are zero, so full-basis projections self-mask
        c1 = _hdot(v_basis, w)
        w = w - _hdot(c1, v_basis)
        c2 = _hdot(v_basis, w)
        w = w - _hdot(c2, v_basis)
        hj = jnp.sqrt(jnp.sum(w * w))
        v_basis = v_basis.at[j + 1].set(
            jnp.where(hj > tiny, w / jnp.maximum(hj, tiny), 0.0))
        h = h.at[:, j].set(c1 + c2)
        h = h.at[j + 1, j].set(hj)
        return v_basis, h

    v_basis, h = lax.fori_loop(0, ncv, step, (v_basis, h))
    t = h[:ncv]
    return 0.5 * (t + t.T), v_basis[:ncv]


def eigsh(a: Any, k: int = 6, *, which: str = "LA", ncv: int | None = None,
          v0: jax.Array | None = None, n: int | None = None, seed: int = 0,
          return_vectors: bool = True):
    """Extremal eigenpairs of a SYMMETRIC operator by Lanczos
    (``scipy.sparse.linalg.eigsh``'s role, on the device and jittable).

    ``which``: ``"LA"`` (largest algebraic), ``"SA"`` (smallest), or
    ``"BE"`` (both ends: ``ceil(k/2)`` from the top, the rest from the
    bottom). ``ncv`` — Krylov size, default ``max(2k + 1, 20)`` capped at
    ``n``; extremal Ritz values converge first, so modest ``ncv`` suffices
    for well-separated ends. Returns ``(evals, evecs, resid)`` —
    ``evals`` ascending ``(k,)``, ``evecs`` row-major ``(k, n)`` Ritz
    vectors (``None`` if ``return_vectors=False``), and ``resid`` the
    per-pair residual norms ``||A v - λ v||`` (device-side; CHECK them —
    interior/unconverged pairs and post-breakdown zero modes announce
    themselves here, there is no implicit-restart loop to drive them
    down).
    """
    if n is None:
        n = v0.shape[-1] if v0 is not None else a.shape[1]
    if ncv is None:
        ncv = max(2 * k + 1, 20)
    ncv = min(ncv, n)
    if not 1 <= k <= ncv:
        raise ValueError(f"need 1 <= k <= ncv, got k={k} ncv={ncv}")
    if which not in ("LA", "SA", "BE"):
        raise ValueError(f"which must be LA|SA|BE, got {which!r}")

    t, v_basis = lanczos(a, ncv, v0=v0, n=n, seed=seed)
    w, s = jnp.linalg.eigh(t)                      # ascending
    if which == "LA":
        idx = jnp.arange(ncv - k, ncv)
    elif which == "SA":
        idx = jnp.arange(k)
    else:                                          # BE
        hi = (k + 1) // 2
        idx = jnp.concatenate([jnp.arange(k - hi), jnp.arange(ncv - hi, ncv)])
    evals = w[idx]
    sv = s[:, idx]                                 # (ncv, k)
    evecs = _hdot(sv.T, v_basis)                   # (k, n) Ritz vectors
    apply = _as_apply(a)
    # lax.map, not vmap: a packed-format spmv may contain a hand kernel
    # with no batching rule; map lowers to a scan of plain applications
    av = lax.map(lambda v: apply(v).astype(jnp.float32), evecs)
    resid = jnp.sqrt(jnp.sum((av - evals[:, None] * evecs) ** 2, axis=1))
    return evals, (evecs if return_vectors else None), resid


def spectrum_bounds(a: Any, *, ncv: int = 32, n: int | None = None,
                    seed: int = 0, safety: float = 1.02):
    """``(lmin, lmax)`` Chebyshev-interval estimates for a symmetric
    positive definite operator (``solve.chebyshev_preconditioner``).

    Ritz values approach the spectrum from INSIDE, so each end is widened
    by its Ritz residual ``r = ||A y - θ y||`` before the ``safety``
    factor: ``λmax <= θ_top + r_top`` is a true containing bound, and the
    low end — which has NO finite-step certificate (on clustered spectra
    the smallest Ritz value can sit orders of magnitude above ``λmin``)
    — degrades gracefully: an unconverged ``r_bot`` pushes ``lmin``
    toward 0, widening the interval (weaker polynomial, but the
    preconditioner stays positive definite) instead of excluding
    spectrum and going indefinite. Converged runs (small ``r``) recover
    tight bounds; CHECK ``eigsh``'s residuals when tightness matters."""
    evals, _, resid = eigsh(a, k=2, which="BE", ncv=ncv, n=n, seed=seed,
                            return_vectors=False)
    lmax = (evals[-1] + resid[-1]) * safety
    lmin = jnp.maximum((evals[0] - resid[0]) / safety, lmax * 1e-8)
    return lmin, lmax
