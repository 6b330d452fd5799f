"""Jittable iterative solvers over the packed sparse formats.

The reference stops at the kernel benchmark; the canonical *consumer* of a
fast SpMV is an iterative solver whose whole runtime IS the SpMV. ``cg``
composes with the packed formats (``fmt.spmv``), with ``jax.jit`` (pure
``lax.while_loop``, static shapes), and with the sharded maps
(``parallel.sparse.sell_spmm_sharded`` closures) — so the measured
kernel speed translates directly into solver throughput.

Convention note: the library op is ``y = x @ A`` (CSR of A.T, formats/csr.py),
i.e. ``fmt.spmv(v) == Aᵀ v`` for the packed dense ``A``. For a SYMMETRIC
system matrix ``S`` this equals ``S v``, so ``cg(fmt, b)`` solves
``S z = b`` when ``fmt`` packs ``S``. For a NONSYMMETRIC ``S`` use
``bicgstab`` with the format packing ``S.T`` (so ``spmv`` applies ``S``).
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
from jax import lax


def _hdot(a, b):
    """Matrix product at full fp32 precision (an fp32 matmul may otherwise
    run in TF32 on the GPU, about three decimal digits)."""
    return jnp.matmul(a, b, precision=lax.Precision.HIGHEST)

def _as_apply(a: Any) -> Callable[[jax.Array], jax.Array]:
    if callable(a) and not hasattr(a, "spmv"):
        return a
    return a.spmv


def cg(a: Any, b: jax.Array, x0: jax.Array | None = None, *,
       tol: float = 1e-5, atol: float = 0.0, maxiter: int | None = None,
       m_inv: Callable[[jax.Array], jax.Array] | None = None):
    """Conjugate gradient for ``S z = b``, ``S`` symmetric positive
    definite.

    ``a`` — a packed format (uses ``a.spmv``) or any callable
    ``v -> v @ S``; symmetry makes that ``S v``. ``m_inv`` — optional
    preconditioner application (e.g. inverse-diagonal / Jacobi).

    Stops when ``||r|| <= max(tol * ||b||, atol)`` or after ``maxiter``
    iterations (default: ``len(b)``). Returns ``(z, info)`` with
    ``info = {"iters", "resnorm"}`` (device scalars — fetching them syncs).
    Fully jittable: fixed-shape ``lax.while_loop``; every iteration is one
    SpMV + a few trivial vector ops, so solver time ~= iters x the
    format's measured SpMV time.
    """
    apply = _as_apply(a)
    b = jnp.asarray(b)
    if b.ndim != 1:
        raise ValueError(f"cg solves one system; b must be 1-D, got "
                         f"shape {b.shape}")
    n = b.shape[-1]
    maxiter = n if maxiter is None else maxiter
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)
    prec = (lambda v: v) if m_inv is None else m_inv

    def vdot(u, v):
        # accumulate reductions in fp32 regardless of operand dtype
        return jnp.sum((u * v).astype(jnp.float32))

    r = b - apply(x)
    z = prec(r)
    p = z
    rz = vdot(r, z)
    limit2 = jnp.maximum(tol * jnp.sqrt(vdot(b, b)), atol) ** 2

    def cond(state):
        _x, r, _p, _z, _rz, k = state
        return (vdot(r, r) > limit2) & (k < maxiter)

    def body(state):
        x, r, p, z, rz, k = state
        ap = apply(p)
        alpha = rz / vdot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = prec(r)
        rz_new = vdot(r, z)
        p = z + (rz_new / rz) * p
        return x, r, p, z, rz_new, k + 1

    x, r, _p, _z, _rz, k = lax.while_loop(
        cond, body, (x, r, p, z, rz, jnp.int32(0)))
    return x, {"iters": k, "resnorm": jnp.sqrt(vdot(r, r))}


def jacobi_preconditioner(diag: jax.Array,
                          eps: float = 1e-12) -> Callable[[jax.Array],
                                                          jax.Array]:
    """Inverse-diagonal preconditioner ``v -> v / diag`` for ``cg``;
    ``diag`` is the system matrix's diagonal (host or device array)."""
    inv = 1.0 / (jnp.asarray(diag) + eps)

    def apply(v):
        return v * inv

    return apply


def bicgstab(a: Any, b: jax.Array, x0: jax.Array | None = None, *,
             tol: float = 1e-5, atol: float = 0.0,
             maxiter: int | None = None,
             m_inv: Callable[[jax.Array], jax.Array] | None = None):
    """BiCGStab for ``S z = b`` with NONSYMMETRIC ``S`` (van der Vorst '92)
    — what ``cg`` cannot touch (convection-diffusion bands, asymmetric
    graph operators). Two SpMVs per iteration, so solver time ~= 2 x iters
    x the format's measured SpMV time.

    ``a`` applies ``v -> S v``: a packed format of ``S.T`` under the
    library's ``y = x @ A`` convention (for symmetric ``S`` pack ``S``
    itself), or any callable. Same stopping rule, preconditioner hook and
    return shape as ``cg``; fully jittable (one fixed-shape
    ``lax.while_loop``). fp32 BiCGStab famously stagnates when the shadow
    residual drifts orthogonal to ``r`` (measured: frozen at resnorm 6.2
    on a 4096-unknown convection-diffusion); the loop RESTARTS
    (``rhat := r``, ``p := r``) whenever the rho inner product's cosine
    degenerates, and harder breakdowns freeze state via ``jnp.where``
    guards instead of NaN-poisoning the jit.
    """
    apply = _as_apply(a)
    b = jnp.asarray(b)
    if b.ndim != 1:
        raise ValueError(f"bicgstab solves one system; b must be 1-D, got "
                         f"shape {b.shape}")
    n = b.shape[-1]
    maxiter = n if maxiter is None else maxiter
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)
    prec = (lambda v: v) if m_inv is None else m_inv
    tiny = jnp.float32(1e-30)

    def vdot(u, v):
        return jnp.sum((u * v).astype(jnp.float32))

    r = b - apply(x)
    rhat = r                                   # shadow residual (restartable)
    rho = alpha = omega = jnp.float32(1.0)
    v = p = jnp.zeros_like(b)
    limit2 = jnp.maximum(tol * jnp.sqrt(vdot(b, b)), atol) ** 2

    def cond(state):
        x, r, *_rest, k = state
        return (vdot(r, r) > limit2) & (k < maxiter)

    def body(state):
        x, r, rhat, p, v, rho, alpha, omega, k = state
        rho_new = vdot(rhat, r)
        rr = vdot(r, r)
        # cosine breakdown test: rhat has drifted ~orthogonal to r — the
        # recurrence is about to stall; restart the Krylov pair from r
        restart = jnp.abs(rho_new) <= 1e-8 * jnp.sqrt(
            vdot(rhat, rhat) * rr) + tiny
        rhat = jnp.where(restart, r, rhat)
        rho_new = jnp.where(restart, rr, rho_new)
        beta = (rho_new / jnp.where(restart, 1.0, rho)) \
            * (alpha / jnp.where(restart, 1.0, omega))
        p = jnp.where(restart, r, r + beta * (p - omega * v))
        ph = prec(p)
        v = apply(ph)
        denom = vdot(rhat, v)
        ok = jnp.abs(denom) > tiny
        alpha = jnp.where(ok, rho_new / jnp.where(ok, denom, 1.0), alpha)
        s = r - alpha * v
        sh = prec(s)
        t = apply(sh)
        tt = vdot(t, t)
        omega_new = jnp.where(tt > tiny, vdot(t, s) / jnp.maximum(tt, tiny),
                              0.0)
        x = jnp.where(ok, x + alpha * ph + omega_new * sh, x)
        r = jnp.where(ok, s - omega_new * t, r)
        omega = jnp.where(ok & (jnp.abs(omega_new) > tiny), omega_new, omega)
        return (x, r, rhat, p, v, jnp.where(ok, rho_new, rho), alpha,
                omega, k + 1)

    x, r, *_rest, k = lax.while_loop(
        cond, body, (x, r, rhat, p, v, rho, alpha, omega, jnp.int32(0)))
    return x, {"iters": k, "resnorm": jnp.sqrt(vdot(r, r))}


def estimate_lmax(a: Any, n: int | None = None, *, iters: int = 20,
                  seed: int = 0, safety: float = 1.1) -> jax.Array:
    """Largest-eigenvalue estimate of the operator by power iteration
    (jittable; ``iters`` SpMVs). ``n`` defaults to the format's output
    width. The ``safety`` factor covers power-iteration undershoot —
    Chebyshev bounds must CONTAIN the spectrum."""
    apply = _as_apply(a)
    if n is None:
        n = a.shape[1]
    v = jax.random.normal(jax.random.PRNGKey(seed), (n,), jnp.float32)

    def step(_, v):
        w = apply(v)
        return w / jnp.maximum(jnp.sqrt(jnp.sum(w * w)), 1e-30)

    v = lax.fori_loop(0, iters, step, v / jnp.sqrt(jnp.sum(v * v)))
    return safety * jnp.sqrt(jnp.sum(apply(v) ** 2))


def chebyshev_preconditioner(a: Any, lmax, lmin=None,
                             degree: int = 8) -> Callable[[jax.Array],
                                                          jax.Array]:
    """Degree-``degree`` Chebyshev polynomial approximation of the
    operator's inverse over ``[lmin, lmax]`` (Saad §12.3 / the standard
    multigrid smoother recurrence), as an ``m_inv`` for ``cg``/
    ``bicgstab``.

    A preconditioner made of SpMVs: each application is ``degree`` pure
    SpMVs — no triangular solves (sequential by nature), no
    extra formats. Why use it when it ADDS SpMV work: (1) it divides the
    number of CG iterations — and each iteration's two dot-product
    reductions are latency-bound all-reduces when the operator is
    sharded, so at pod scale fewer iterations of more local bandwidth
    work is the winning trade (measured single-chip on the 32x32
    Laplacian: 77 plain CG iters -> 13 at degree 8); (2) fp32 Krylov
    recurrences on cond >~1e3 systems stagnate (see ``bicgstab``) —
    the preconditioned system's condition is what the iteration sees.
    ``lmin`` defaults to ``lmax / 30`` (the multigrid smoothing-range
    convention; exact bounds are not required, containment is) — for
    EXACT bounds use ``tpusparse.eig.spectrum_bounds`` (Lanczos, both
    spectrum ends in one pass).
    """
    apply = _as_apply(a)
    lmax = jnp.asarray(lmax, jnp.float32)
    lmin = lmax / 30.0 if lmin is None else jnp.asarray(lmin, jnp.float32)
    theta = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0
    sigma = theta / delta

    def m_inv(v):
        rho = 1.0 / sigma
        d = v / theta
        z = d
        r = v - apply(z)
        for _ in range(degree - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * r
            z = z + d
            r = r - apply(d)
            rho = rho_new
        return z

    return m_inv


def gmres(a: Any, b: jax.Array, x0: jax.Array | None = None, *,
          tol: float = 1e-5, atol: float = 0.0, restart: int = 30,
          maxiter: int | None = None,
          m_inv: Callable[[jax.Array], jax.Array] | None = None):
    """Restarted GMRES(``restart``) for ``S z = b``, ``S`` nonsymmetric —
    the minimal-residual workhorse when BiCGStab's erratic convergence is
    unacceptable. One SpMV per inner step plus two (restart+1, n) matmuls
    for the orthogonalization.

    Same operator convention as ``bicgstab`` (pack ``S.T``). ``m_inv`` is
    applied on the RIGHT (``S M⁻¹ u = b``, ``z = M⁻¹ u``) so the residual
    test sees the TRUE residual. Orthogonalization is CGS2 (two classical
    Gram–Schmidt passes): unlike sequential MGS its projections are two
    dense matmuls over the whole basis — accelerator-friendly and one
    all-reduce per pass when sharded — with MGS-grade stability.

    Fully jittable: the Arnoldi cycle is a fixed-shape ``fori_loop`` over
    a (restart+1, n) basis, the restart cycle a ``while_loop``, and the
    small (restart+1, restart) least-squares solve uses
    ``jnp.linalg.lstsq`` (rank-deficient-safe, so a lucky breakdown mid-
    cycle — zero basis tail — is harmless). ``maxiter`` counts INNER
    steps (like ``cg``); cycles are whole, so up to ``restart - 1`` extra
    steps run past it. ``info['iters']`` is the inner-step count.
    """
    apply = _as_apply(a)
    b = jnp.asarray(b)
    if b.ndim != 1:
        raise ValueError(f"gmres solves one system; b must be 1-D, got "
                         f"shape {b.shape}")
    n = b.shape[-1]
    maxiter = n if maxiter is None else maxiter
    max_outer = -(-maxiter // restart)
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)
    prec = (lambda v: v) if m_inv is None else m_inv
    tiny = jnp.float32(1e-30)

    def vdot(u, v):
        return jnp.sum((u * v).astype(jnp.float32))

    limit = jnp.maximum(tol * jnp.sqrt(vdot(b, b)), atol)
    e1 = jnp.zeros(restart + 1, jnp.float32).at[0].set(1.0)

    def cycle(x):
        r = b - apply(x)
        beta = jnp.sqrt(vdot(r, r))
        v_basis = jnp.zeros((restart + 1, n), jnp.float32)
        v_basis = v_basis.at[0].set(r / jnp.maximum(beta, tiny))
        h = jnp.zeros((restart + 1, restart), jnp.float32)

        def arnoldi(j, carry):
            v_basis, h = carry
            w = apply(prec(v_basis[j]))
            # CGS2: rows past j are zero, so the full-basis projections
            # are self-masking
            c1 = _hdot(v_basis, w)
            w = w - _hdot(c1, v_basis)
            c2 = _hdot(v_basis, w)
            w = w - _hdot(c2, v_basis)
            hj = jnp.sqrt(vdot(w, w))
            v_basis = v_basis.at[j + 1].set(
                jnp.where(hj > tiny, w / jnp.maximum(hj, tiny), 0.0))
            h = h.at[:, j].set(c1 + c2)
            h = h.at[j + 1, j].set(hj)
            return v_basis, h

        v_basis, h = lax.fori_loop(0, restart, arnoldi, (v_basis, h))
        y, *_ = jnp.linalg.lstsq(h, beta * e1)
        return x + prec(_hdot(y, v_basis[:restart]))

    r0 = b - apply(x)

    def cond(state):
        _x, res, k = state
        return (res > limit) & (k < max_outer)

    def body(state):
        x, _res, k = state
        x = cycle(x)
        r = b - apply(x)
        return x, jnp.sqrt(vdot(r, r)), k + 1

    x, res, k = lax.while_loop(
        cond, body, (x, jnp.sqrt(vdot(r0, r0)), jnp.int32(0)))
    return x, {"iters": k * restart, "resnorm": res}


def cg_multi(a: Any, b: jax.Array, x0: jax.Array | None = None, *,
             tol: float = 1e-5, atol: float = 0.0, maxiter: int | None = None,
             m_inv: Callable[[jax.Array], jax.Array] | None = None):
    """Batched CG: ``S Z[i] = B[i]`` for ``nrhs`` right-hand sides at once,
    ``S`` SPD. ``b`` is ``(nrhs, n)`` (the library's SpMM batch-major
    convention); every iteration runs ONE SpMM instead of ``nrhs`` SpMVs,
    so the matrix bytes — the whole cost of a memory-bound solve — are
    amortized across the batch, and ``auto_format(expect_batch=nrhs)``
    routing (TCSR/ASP over gather-bound SELL)
    applies to the solver unchanged.

    Each column carries its own alpha/beta/residual; converged columns
    freeze through ``jnp.where`` masks (their alpha forces to 0) while the
    rest keep iterating — the loop exits when ALL are below their limits
    (per-column ``max(tol * ||b_i||, atol)``) or at ``maxiter``.
    ``info["resnorm"]`` is per-column ``(nrhs,)``; ``iters`` is the shared
    iteration count. Fully jittable; ``m_inv`` must map ``(nrhs, n) ->
    (nrhs, n)`` (elementwise preconditioners like ``jacobi_preconditioner``
    broadcast as-is).
    """
    apply = a if callable(a) and not hasattr(a, "spmm") else a.spmm
    b = jnp.asarray(b)
    if b.ndim != 2:
        raise ValueError(f"cg_multi wants b of shape (nrhs, n); got "
                         f"{b.shape} (for one system use cg)")
    n = b.shape[-1]
    maxiter = n if maxiter is None else maxiter
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)
    prec = (lambda v: v) if m_inv is None else m_inv
    tiny = jnp.float32(1e-30)

    def rowdot(u, v):                      # (nrhs, 1) fp32 reductions
        return jnp.sum((u * v).astype(jnp.float32), axis=1, keepdims=True)

    r = b - apply(x)
    z = prec(r)
    p = z
    rz = rowdot(r, z)
    limit2 = jnp.maximum(tol * jnp.sqrt(rowdot(b, b)), atol) ** 2

    def cond(state):
        _x, r, _p, _z, _rz, k = state
        return jnp.any(rowdot(r, r) > limit2) & (k < maxiter)

    def body(state):
        x, r, p, z, rz, k = state
        active = rowdot(r, r) > limit2
        ap = apply(p)
        pap = rowdot(p, ap)
        alpha = jnp.where(active & (jnp.abs(pap) > tiny),
                          rz / jnp.where(jnp.abs(pap) > tiny, pap, 1.0), 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        z = prec(r)
        rz_new = rowdot(r, z)
        beta = jnp.where(active & (jnp.abs(rz) > tiny),
                         rz_new / jnp.where(jnp.abs(rz) > tiny, rz, 1.0), 0.0)
        p = jnp.where(active, z + beta * p, p)
        return x, r, p, z, jnp.where(active, rz_new, rz), k + 1

    x, r, _p, _z, _rz, k = lax.while_loop(
        cond, body, (x, r, p, z, rz, jnp.int32(0)))
    return x, {"iters": k, "resnorm": jnp.sqrt(rowdot(r, r))[:, 0]}
