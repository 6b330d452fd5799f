#!/usr/bin/env python
"""Smoke run of tpusparse's main path on one GPU.

Drives the public entry points at sizes a sparse-library user would call
real, compiled for the card, and checks every result against a float64
reference on the host:

- ``route``: one matrix per branch of ``formats/auto.py:route`` through
  ``auto_format`` -> ``spmv`` / ``spmm`` (B=8), plus the formats the router
  does not emit (binned SELL, BSR) and SELL with bf16 / int8 storage;
- ``solve``: CG preconditioned by a smoothed-aggregation AMG V-cycle on the
  1,048,576-unknown 2-D Laplacian (the path of
  ``cli solve --side 1024 --precond amg``);
- ``train``: ``trainable_linear`` on a 2:4-pruned 4096^2 weight, batch 32,
  three SGD steps, gradients checked against the dense product.

``--four-cards`` runs only the sharded paths on four cards, each compared
with the single-device product.

Usage: ``python chip_smoke.py [--four-cards]``. It refuses to run without a
GPU. Each case prints the card (name, power limit), the routed format, the
implementation that ran (always the XLA form: the package has no
hand-written kernel), max|err| and a steady-state time per call; the last
line is one JSON object, printed only when every phase passed.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np


def _fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(2)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    return out[0] if out else "nvidia-smi printed nothing"


def median_time(fn, *args, reps: int = 20) -> float:
    """Steady-state seconds per call: warm up, then the median of ``reps``
    calls, each ended by ``block_until_ready``."""
    import jax

    for _ in range(3):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def csr_product(csr, x: np.ndarray) -> np.ndarray:
    """O(nnz) float64 ``x @ A`` from the CSR triplets (CSR of A.T)."""
    from scipy import sparse as ssp

    m, n = csr.shape
    at = ssp.csr_matrix((csr.values.astype(np.float64), csr.col_idx,
                         csr.row_ptr), shape=(n, m))
    return np.asarray(at @ np.asarray(x, np.float64).T).T


def run_case(name, fmt, x1, xb, ref1, refb, *, expect=None, tol=1e-3):
    """Products of one packed matrix at B=1 and B=8: routed format,
    max|err| against the float64 reference, time per call. Returns True when the result is within ``tol`` (and the route
    is the expected one)."""
    import jax
    import jax.numpy as jnp

    routed = type(fmt).__name__
    fmt = jax.device_put(fmt)
    spmv = jax.jit(lambda f, x: f.spmv(x))
    spmm = jax.jit(lambda f, x: f.spmm(x))
    x1d, xbd = jnp.asarray(x1), jnp.asarray(xb)
    y1 = np.asarray(spmv(fmt, x1d), np.float64)
    yb = np.asarray(spmm(fmt, xbd), np.float64)
    finite = bool(np.isfinite(y1).all() and np.isfinite(yb).all())
    err = max(float(np.abs(y1 - ref1).max()), float(np.abs(yb - refb).max()))
    t1 = median_time(spmv, fmt, x1d)
    t8 = median_time(spmm, fmt, xbd)
    ok = finite and err <= tol and (expect is None or routed == expect)
    print(f"[route] {name}: format={routed}"
          f"{'' if expect is None else f' (expected {expect})'} "
          f"impl=xla max|err|={err:.3e} (tol {tol:g}) "
          f"spmv={t1 * 1e6:.1f}us spmm[B=8]={t8 * 1e6:.1f}us "
          f"bytes={fmt.device_bytes() / 1e6:.1f}MB "
          f"{'OK' if ok else 'FAIL'}", flush=True)
    return ok


def phase_route(scale: int = 1) -> bool:
    """One matrix per router branch; ``scale`` divides the sizes (CPU
    rehearsals only)."""
    from tpusparse import auto_format
    from tpusparse.formats.binned import BinnedSellMatrix
    from tpusparse.formats.bsr import BsrMatrix
    from tpusparse.formats.csr import CsrMatrix
    from tpusparse.formats.sell import SellMatrix
    from tpusparse.testing import generators, reference

    ok = True
    n4 = 4096 // scale

    def dense_case(name, a, expect, x1, xb, fmt=None, route_kw=None, **kw):
        ref1 = reference.sgemv_cpu(x1, a).astype(np.float64)
        refb = reference.sgemm_cpu(xb, a).astype(np.float64)
        if fmt is None:
            fmt = auto_format(a, **(route_kw or {}))
        return run_case(name, fmt, x1, xb, ref1, refb, expect=expect, **kw)

    def vecs(m, seed):
        return (generators.random_sparse_vector(m, 0.5, seed=seed),
                generators.random_sparse_batch(8, m, 0.5, seed=seed))

    # the reference configuration (test/main.cpp:4): 4096^2, d=0.5, X d=0.5
    a = generators.random_sparse_matrix(n4, n4, 0.5, seed=1)
    x1, xb = vecs(n4, 1)
    ok &= dense_case("reference 4096^2 d=0.5", a, "SellMatrix", x1, xb)

    # SELL with reduced-precision storage, at the tolerances their tests
    # state (bf16 5e-2, int8 1e-1); d=0.1 keeps the quantization sum short
    a01 = generators.random_sparse_matrix(n4, n4, 0.1, seed=7)
    x1q, xbq = vecs(n4, 7)
    import jax.numpy as jnp

    ok &= dense_case("sell bf16 4096^2 d=0.1", a01, None, x1q, xbq,
                     fmt=SellMatrix.from_dense(a01, dtype=jnp.bfloat16),
                     tol=5e-2)
    ok &= dense_case("sell int8 4096^2 d=0.1", a01, None, x1q, xbq,
                     fmt=SellMatrix.from_dense(a01, dtype="int8"), tol=1e-1)
    del a01

    # AWSP: structured (ReLU-block) activations, device-side plan
    xr1, xrb = x1.copy(), xb.copy()
    live = np.random.default_rng(3).random(n4 // 128) < 0.25
    dead = np.repeat(~live, 128)
    xr1[dead] = 0.0
    xrb[:, dead] = 0.0
    ok &= dense_case("relu-block X 4096^2 d=0.5", a, "AwspMatrix", xr1, xrb,
                     route_kw=dict(expect_structured_x=True))
    del a

    a = generators.random_sparse_matrix(n4, n4, 0.8, seed=2)
    x1, xb = vecs(n4, 2)
    ok &= dense_case("4096^2 d=0.8", a, "AspMatrix", x1, xb)
    del a

    n8 = 8192 // scale
    a = generators.random_sparse_matrix(n8, n8, 0.3, seed=4,
                                        distribution="blocks")
    x1, xb = vecs(n8, 4)
    ok &= dense_case("8192^2 blocks", a, "TcsrMatrix", x1, xb)
    ok &= dense_case("8192^2 blocks as BSR (direct)", a, None, x1, xb,
                     fmt=BsrMatrix.from_dense(a))
    del a

    def csr_case(name, csr, expect, fmt=None):
        x1, xb = vecs(csr.shape[0], 5)
        return run_case(name, fmt if fmt is not None else auto_format(csr),
                        x1, xb, csr_product(csr, x1[None])[0],
                        csr_product(csr, xb), expect=expect)

    n16 = 16384 // scale
    csr = generators.random_sparse_csr(n16, n16, 0.01, seed=6,
                                       distribution="powerlaw")
    ok &= csr_case("16384^2 powerlaw d=0.01", csr, "RsellMatrix")
    ok &= csr_case("16384^2 powerlaw as binned SELL (direct)", csr, None,
                   fmt=BinnedSellMatrix.from_csr(csr))

    side = 1024 // scale
    ok &= csr_case(f"2-D Laplacian {side}^2 grid", laplacian(side),
                   "DiaMatrix")

    mtx = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "fem_mesh_16384.mtx")
    csr = CsrMatrix.from_mtx(mtx)
    csr.values = csr.values.astype(np.float32)
    ok &= csr_case("data/fem_mesh_16384.mtx", csr, None)
    return ok


def laplacian(side: int):
    """5-point 2-D Laplacian on a side x side grid, as CsrMatrix."""
    from scipy import sparse as ssp

    from tpusparse.formats.csr import CsrMatrix

    t = ssp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(side, side))
    lap = (ssp.kron(ssp.eye(side), t) + ssp.kron(t, ssp.eye(side))).tocsr()
    return CsrMatrix.from_scipy(lap.astype(np.float32))


def phase_solve(side: int = 1024, tol: float = 1e-5) -> bool:
    """AMG-preconditioned CG, converged by ``cli solve``'s own test."""
    import jax
    import jax.numpy as jnp

    from tpusparse import auto_format
    from tpusparse.amg import smoothed_aggregation
    from tpusparse.solve import cg

    csr = laplacian(side)
    n = csr.shape[0]
    fmt = jax.device_put(auto_format(csr))
    t0 = time.perf_counter()
    amg = smoothed_aggregation(csr, degree=2)
    t_setup = time.perf_counter() - t0
    b = np.random.default_rng(0).normal(size=n).astype(np.float32)

    @jax.jit
    def jsolve(f, bb, ps):
        return cg(f, bb, tol=tol, m_inv=lambda r: ps._cycle(0, r))

    def run():
        t0 = time.perf_counter()
        z, info = jsolve(fmt, jnp.asarray(b), amg)
        res = float(info["resnorm"])          # fetch waits for the device
        return z, int(info["iters"]), res, time.perf_counter() - t0

    _, _, _, t_cold = run()
    z, iters, res, t_warm = run()
    az = csr_product(csr, np.asarray(z)[None])[0]
    err = float(np.abs(az - b.astype(np.float64)).max())
    ok = res <= tol * float(np.linalg.norm(b)) * 1.01
    print(f"[solve] cg+amg {side}^2 Laplacian (n={n}): "
          f"format={type(fmt).__name__} {iters} iters, resnorm {res:.3e}, "
          f"max|Az-b| {err:.3e} (float64, host), setup {t_setup:.1f}s, "
          f"solve {t_warm * 1e3:.1f}ms warm ({t_cold:.1f}s cold) "
          f"{'OK' if ok else 'NOT CONVERGED'}", flush=True)
    return ok


def phase_train(n: int = 4096, batch: int = 32, steps: int = 3) -> bool:
    """trainable_linear: the loss falls over SGD steps, and d/dx, d/dvals
    match jax.grad of the dense product at HIGHEST precision."""
    import jax
    import jax.numpy as jnp

    from tpusparse import nm_prune, trainable_linear

    rng = np.random.default_rng(0)
    csr = nm_prune(rng.normal(size=(n, n)).astype(np.float32) / np.sqrt(n))
    apply, params, masks, _ = trainable_linear(csr)
    statics = jax.device_put(apply.statics)
    params = jax.device_put(params)
    x = jnp.asarray(rng.normal(size=(batch, n)).astype(np.float32))
    target = jnp.asarray(rng.normal(size=(batch, n)).astype(np.float32))

    def loss(p, xx):
        return jnp.mean((apply(p, xx, statics=statics) - target) ** 2)

    step = jax.jit(jax.value_and_grad(loss))
    losses = []
    t_steps = []
    p = params
    for _ in range(steps):
        t0 = time.perf_counter()
        val, g = step(p, x)
        p = jax.tree_util.tree_map(lambda a, b: a - 0.5 * b, p, g)
        losses.append(float(val))
        t_steps.append(time.perf_counter() - t0)
    falls = all(b < a for a, b in zip(losses, losses[1:]))

    # gradients at the initial values against the dense product
    gy = jnp.asarray(rng.normal(size=(batch, n)).astype(np.float32))
    dvals, dx = jax.jit(jax.grad(
        lambda p_, xx: jnp.sum(apply(p_, xx, statics=statics) * gy),
        argnums=(0, 1)))(params, x)
    a_dense = jnp.asarray(csr.to_dense())
    hi = jax.lax.Precision.HIGHEST
    dx_ref, da_ref = jax.jit(jax.grad(
        lambda xx, aa: jnp.sum(jnp.dot(xx, aa, precision=hi) * gy),
        argnums=(0, 1)))(x, a_dense)
    # d/dvals: live slot [j, t, s, r] is A[t*128 + idx, j*128 + r]
    idx = np.asarray(apply.statics["idx"]).astype(np.int64)
    jj, tt, ss, rr = np.nonzero(masks["vals"])
    mrow = tt * 128 + idx[jj, tt, ss, rr]
    ncol = jj * 128 + rr
    dv = np.asarray(dvals["vals"])[jj, tt, ss, rr]
    dv_ref = np.asarray(da_ref)[mrow, ncol]
    dx_ref = np.asarray(dx_ref)
    # fp32 sums in another order than the dense reference: hold both to
    # 1e-4 of the largest reference magnitude
    e_dx = float(np.abs(np.asarray(dx) - dx_ref).max())
    e_dv = float(np.abs(dv - dv_ref).max())
    tol_dx = 1e-4 * float(np.abs(dx_ref).max())
    tol_dv = 1e-4 * float(np.abs(dv_ref).max())
    ok = falls and e_dx <= tol_dx and e_dv <= tol_dv
    print(f"[train] trainable_linear 2:4 {n}^2, batch {batch}: losses "
          f"{', '.join(f'{v:.5f}' for v in losses)} "
          f"({'falling' if falls else 'NOT FALLING'}); "
          f"max|d/dx err| {e_dx:.2e} (tol {tol_dx:.2e}), "
          f"max|d/dvals err| {e_dv:.2e} (tol {tol_dv:.2e}); "
          f"step {np.median(t_steps[1:] or t_steps) * 1e3:.2f}ms "
          f"(first {t_steps[0]:.1f}s incl. compile) "
          f"{'OK' if ok else 'FAIL'}", flush=True)
    return ok


def phase_four_cards(scale: int = 1) -> bool:
    """The sharded paths on a 4-device mesh, each against the
    single-device product of the same format."""
    import jax
    import jax.numpy as jnp

    from tpusparse import trainable_linear, trainable_linear_sharded
    from tpusparse.amg import smoothed_aggregation
    from tpusparse.formats.dia import DiaMatrix
    from tpusparse.formats.rsell import RsellMatrix, rsell_shard_pack
    from tpusparse.formats.sell import SellMatrix
    from tpusparse.formats.tcsr import TcsrMatrix
    from tpusparse.parallel.mesh import make_mesh
    from tpusparse.parallel.sparse import (dia_spmm_sharded,
                                           rsell_spmm_sharded,
                                           sell_spmm_sharded,
                                           tcsr_shard_pack, tcsr_spmm_sharded)
    from tpusparse.testing import generators

    devs = jax.devices()[:4]
    mesh = make_mesh({"n": 4}, devs)
    mesh2d = make_mesh({"b": 2, "n": 2}, devs)
    ok = True

    def compare(name, got, want, tol=1e-3, t=None):
        got = np.asarray(got, np.float64)
        want = np.asarray(want, np.float64)
        err = float(np.abs(got - want).max())
        good = bool(np.isfinite(got).all()) and err <= tol
        print(f"[four-cards] {name}: max|err| vs single device {err:.3e} "
              f"(tol {tol:g})"
              f"{'' if t is None else f' {t * 1e6:.1f}us/call'} "
              f"{'OK' if good else 'FAIL'}", flush=True)
        return good

    def timed(fn, *args):
        return fn(*args), median_time(fn, *args, reps=10)

    n8 = 8192 // scale
    a = generators.random_sparse_matrix(n8, n8, 0.5, seed=11)
    s = SellMatrix.from_dense(a)
    del a
    xb = jnp.asarray(generators.random_sparse_batch(8, n8, 0.5, seed=11))
    want = jax.jit(lambda f, x: f.spmm(x))(jax.device_put(s), xb)
    for part in ("n", "m", "ring", "2d"):
        msh = mesh2d if part == "2d" else mesh
        got, t = timed(jax.jit(
            lambda x, p=part, mm=msh: sell_spmm_sharded(s, x, mm, p)), xb)
        ok &= compare(f"sell_spmm_sharded[{part}] {n8}^2 d=0.5 B=8",
                      got, want, t=t)
    del s

    n32 = 32768 // scale
    csr = generators.random_sparse_csr(n32, n32, 0.01, seed=12,
                                       distribution="powerlaw")
    xb = jnp.asarray(generators.random_sparse_batch(8, n32, 0.5, seed=12))
    want = jax.jit(lambda f, x: f.spmm(x))(
        jax.device_put(RsellMatrix.from_csr(csr)), xb)
    sh = rsell_shard_pack(csr, 4, assignment="balance")
    got, t = timed(jax.jit(lambda x: rsell_spmm_sharded(sh, x, mesh)), xb)
    ok &= compare(f"rsell_spmm_sharded[balance] {n32}^2 powerlaw d=0.01 "
                  f"B=8", got, want, t=t)
    del sh, csr

    n16 = 16384 // scale
    a = generators.random_sparse_matrix(n16, n16, 0.3, seed=13,
                                        distribution="blocks")
    xb = jnp.asarray(generators.random_sparse_batch(8, n16, 0.5, seed=13))
    want = jax.jit(lambda f, x: f.spmm(x))(
        jax.device_put(TcsrMatrix.from_dense(a)), xb)
    packed = tcsr_shard_pack(a, 4)
    del a
    got, t = timed(jax.jit(lambda x: tcsr_spmm_sharded(packed, x, mesh)), xb)
    ok &= compare(f"tcsr_spmm_sharded[n] {n16}^2 blocks B=8", got, want, t=t)
    del packed

    side = 2048 // scale
    lap = laplacian(side)
    dm = DiaMatrix.from_csr(lap)
    x1 = jnp.asarray(generators.random_sparse_vector(side * side, 0.5,
                                                     seed=14))
    want = jax.jit(lambda f, x: f.spmv(x))(jax.device_put(dm), x1)
    got, t = timed(jax.jit(lambda x: dia_spmm_sharded(dm, x, mesh, "halo")),
                   x1)
    ok &= compare(f"dia_spmm_sharded[halo] {side}^2 Laplacian", got, want,
                  t=t)

    b = jnp.asarray(np.random.default_rng(0).normal(
        size=side * side).astype(np.float32))
    for mode in ("grid", "greedy"):
        t0 = time.perf_counter()
        if mode == "grid":
            h1 = smoothed_aggregation(lap, aggregation="grid")
            hs = h1.shard(mesh)
        else:
            h1 = smoothed_aggregation(lap, aggregation="greedy")
            hs = smoothed_aggregation(lap, aggregation="greedy", mesh=mesh)
        t_setup = time.perf_counter() - t0
        z1, i1 = h1.solve(b, tol=1e-5)
        zs, i_s = hs.solve(b, tol=1e-5)
        # both stop at a 1e-5 relative (fp32, recursive) residual, so the
        # check is the true float64 residual of the sharded solution and an
        # iteration count within 2 of the single-device solve
        az = csr_product(lap, np.asarray(zs)[None])[0]
        res = float(np.linalg.norm(az - np.asarray(b, np.float64)) /
                    np.linalg.norm(np.asarray(b, np.float64)))
        good = res <= 1e-4 and abs(int(i_s["iters"]) - int(i1["iters"])) <= 2
        print(f"[four-cards] amg {mode} sharded solve {side}^2: "
              f"{int(i_s['iters'])} iters (single device "
              f"{int(i1['iters'])}), float64 rel. residual {res:.2e}, "
              f"setup {t_setup:.1f}s {'OK' if good else 'FAIL'}",
              flush=True)
        ok &= good

    n4 = 4096 // scale
    w = np.random.default_rng(15).normal(size=(n4, n4)).astype(np.float32)
    from tpusparse import nm_prune

    csr = nm_prune(w / np.sqrt(n4))
    x = jnp.asarray(np.random.default_rng(16).normal(
        size=(32, n4)).astype(np.float32))
    ap1, p1, _, _ = trainable_linear(csr)
    aps, ps, _, _ = trainable_linear_sharded(csr, mesh)

    def step(apply):
        return jax.jit(jax.value_and_grad(
            lambda p, xx: jnp.mean(apply(p, xx) ** 2)))

    l1, g1 = step(ap1)(p1, x)
    ls, gs = step(aps)(ps, x)
    # fp32 sums in another order: 1e-4 of the largest magnitude
    ok &= compare(f"trainable_linear_sharded step {n4}^2 2:4 loss",
                  ls, l1, tol=1e-4 * abs(float(l1)))
    for k in ("vals", "vals_t"):
        ok &= compare(f"trainable_linear_sharded step d/d{k}", gs[k], g1[k],
                      tol=1e-4 * float(np.abs(np.asarray(g1[k])).max()))
    return ok


def main(argv: list[str]) -> int:
    import jax

    if jax.default_backend() != "gpu":
        _fail(f"needs a GPU; JAX's default backend is "
              f"{jax.default_backend()!r}")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpusparse.utils import enable_compile_cache

    enable_compile_cache()
    four = "--four-cards" in argv
    devs = jax.devices()
    need = 4 if four else 1
    if len(devs) < need:
        _fail(f"needs {need} GPUs, JAX sees {len(devs)}")
    print(f"card: {card()}", flush=True)
    print(f"jax {jax.__version__}, {len(devs)} x {devs[0].device_kind}",
          flush=True)
    phases = ([("four-cards", phase_four_cards)] if four else
              [("route", phase_route), ("solve", phase_solve),
               ("train", phase_train)])
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            good = fn()
        except Exception as e:            # report, then fail the run
            import traceback

            traceback.print_exc()
            print(f"[{name}] raised {type(e).__name__}: {e}", flush=True)
            good = False
        print(f"[{name}] phase {'passed' if good else 'FAILED'} in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        if not good:
            failed.append(name)
    print(card(), flush=True)
    if failed:
        print(f"chip_smoke: phases failed: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
