"""CLI: correctness runs, benchmark sweeps, profiling.

Replaces the reference's hard-coded entry point (test/main.cpp:4 — fixed
4096x4096, fixed kernel list) and profile.sh (Nsight Compute capture) with a
configurable command line:

    python -m tpusparse.cli check --m 4096 --n 4096 --density 0.5
    python -m tpusparse.cli bench --kernels dense_xla,sell
    python -m tpusparse.cli profile --trace-dir /tmp/trace
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _add_workload_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--m", type=int, default=4096)
    p.add_argument("--n", type=int, default=4096)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--density", type=float, default=0.5)
    p.add_argument("--x-density", type=float, default=0.5)
    p.add_argument("--distribution", default="uniform",
                   choices=["uniform", "powerlaw", "banded", "blocks"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--kernels", default="all",
                   help="comma-separated kernel names, or 'all'")
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU backend")


def _config_from(args) -> "SpmvConfig":
    from tpusparse.config import SpmvConfig

    return SpmvConfig(m=args.m, n=args.n, batch=args.batch,
                      density=args.density, x_density=args.x_density,
                      distribution=args.distribution, seed=args.seed)


def _select(entries, names: str):
    if names == "all":
        return entries
    wanted = [s.strip() for s in names.split(",")]
    by_name = {e["name"]: e for e in entries}
    missing = [w for w in wanted if w not in by_name]
    if missing:
        raise SystemExit(
            f"unknown kernels: {missing}; available: {sorted(by_name)}")
    return [by_name[w] for w in wanted]


def cmd_check(args) -> int:
    from tpusparse.bench.suite import registry
    from tpusparse.testing.tester import KernelEntry, SpmvTester

    tester = SpmvTester(_config_from(args))
    for e in _select(registry(), args.kernels):
        tester.register(KernelEntry(e["name"], e["prepare"], e["run"]))
    reports = tester.run(raise_on_fail=False)
    return 0 if all(r.ok for r in reports) else 1


def cmd_bench(args) -> int:
    """Kernel sweep; ``--format json|csv`` emits one machine-readable record
    per kernel x matrix (SURVEY.md §5: structured results replace the
    reference's stdout banners)."""
    from tpusparse.bench.roofline import roofline_fraction
    from tpusparse.bench.suite import registry, sweep

    cfg = _config_from(args)
    results = sweep(cfg, verbose=args.format == "text",
                    entries=_select(registry(), args.kernels))
    if args.format == "text":
        return 0
    records = [
        dict(kernel=r.name, m=cfg.m, n=cfg.n, batch=cfg.batch,
             density=cfg.density, x_density=cfg.x_density,
             distribution=cfg.distribution, seed=cfg.seed,
             us=round(r.seconds * 1e6, 2),
             gbps=round(r.gbps, 1) if r.gbps else None,
             gflops=round(r.gflops, 1) if r.gflops else None,
             gnnz_per_s=round(r.nnz_per_s / 1e9, 3) if r.nnz_per_s else None,
             roofline_frac=round(
                 roofline_fraction(r.bytes_moved, r.seconds), 3)
             if r.bytes_moved else None,
             bytes_moved=r.bytes_moved)
        for r in results
    ]
    if args.format == "json":
        for rec in records:
            print(json.dumps(rec))
    else:                                          # csv
        import csv as _csv
        import sys as _sys

        if not records:
            return 0
        w = _csv.DictWriter(_sys.stdout, fieldnames=list(records[0]))
        w.writeheader()
        w.writerows(records)
    return 0


def cmd_headline(args) -> int:
    from tpusparse.bench.suite import headline

    print(json.dumps(headline()))
    return 0


def cmd_profile(args) -> int:
    """Capture an XProf/Perfetto trace of one sweep (ncu/profile.sh analog)."""
    import jax

    from tpusparse.bench.suite import sweep

    with jax.profiler.trace(args.trace_dir):
        sweep(_config_from(args), verbose=True)
    print(f"trace written to {args.trace_dir} (open with XProf/Perfetto)")
    return 0


def cmd_mtx(args) -> int:
    """Route, validate, and time a real matrix from a MatrixMarket file.

    End-to-end no-densify path: CSR ingestion -> O(nnz) statistics ->
    auto_format -> device timing, with correctness checked against an
    O(nnz) float64 oracle computed straight from the triplets.
    """
    import numpy as np

    from tpusparse.bench.roofline import roofline_fraction
    from tpusparse.bench.runner import device_time
    from tpusparse.formats.auto import auto_format, matrix_stats_csr
    from tpusparse.formats.csr import CsrMatrix
    from tpusparse.testing import generators

    csr = CsrMatrix.from_mtx(args.file)
    if csr.values.dtype != np.float32:
        csr.values = csr.values.astype(np.float32)
    m, n = csr.shape
    s = matrix_stats_csr(csr)
    print(f"{args.file}: {m}x{n}, nnz={s['nnz']} (d={s['density']:.4f}), "
          f"empty 128x128 tiles {s['empty_block_frac']*100:.0f}%, "
          f"width demand max/typical {s['w_global']}/{s['w_typical']:.0f}")
    fmt = auto_format(csr, stats=s, expect_batch=args.batch)
    print(f"routed to {fmt!r}")

    x = generators.random_sparse_vector(m, density=args.x_density,
                                        seed=args.seed)
    y = np.asarray(fmt.spmv(x))
    y_ref = np.zeros(n, dtype=np.float64)
    rr = np.repeat(np.arange(n), csr.row_nnz)
    np.add.at(y_ref, rr, csr.values.astype(np.float64) *
              x.astype(np.float64)[csr.col_idx])
    err = float(np.max(np.abs(y - y_ref))) if n else 0.0
    print(f"max|err| vs float64 oracle: {err:.3e} "
          f"({'OK' if err <= 1e-3 else 'FAIL'})")
    if getattr(args, "no_time", False):
        # ingest->route->oracle only (a device timing is meaningless on
        # the CPU backend and slow at real sizes)
        return 0 if err <= 1e-3 else 1

    # time the workload shape the routing was asked for: spmm at --batch>1
    xt = x if args.batch <= 1 else generators.random_sparse_batch(
        args.batch, m, density=args.x_density, seed=args.seed)
    # activation-skip formats need a concrete plan under the jitted timing
    # chain; the plan for THIS x is the honest serving behavior
    plan = fmt.plan(xt) if hasattr(fmt, "plan") else None
    op = "spmv" if args.batch <= 1 else f"spmm[B={args.batch}]"

    def run(f, xx):
        kw = {} if plan is None else {"plan": plan}
        return f.spmv(xx, **kw) if xx.ndim == 1 else f.spmm(xx, **kw)

    nbytes = fmt.device_bytes()
    r = device_time(run, fmt, xt, name=op, bytes_moved=nbytes, nnz=s["nnz"])
    frac = roofline_fraction(nbytes, r.seconds)
    print(f"{r} | {frac*100:.0f}% of the memory roofline on its own bytes "
          f"({nbytes/1e6:.1f} MB streamed vs {m*n*4/1e6:.1f} MB dense)")
    return 0 if err <= 1e-3 else 1


def cmd_solve(args) -> int:
    """End-to-end iterative solve: ingest (or generate), route, precondition,
    solve, verify against the O(nnz) float64 residual.

    Matrix: ``--file x.mtx`` or a generated 2-D Laplacian (``--side``).
    Solvers: cg (SPD), bicgstab, gmres. Preconditioners: none, jacobi,
    chebyshev (Lanczos spectrum bounds), amg (smoothed aggregation).
    """
    import time as _time

    import numpy as np

    import jax
    import jax.numpy as jnp

    from tpusparse.formats.auto import auto_format, matrix_stats_csr
    from tpusparse.formats.csr import CsrMatrix
    from tpusparse import solve as _solve

    if args.file:
        csr = CsrMatrix.from_mtx(args.file)
        if csr.values.dtype != np.float32:
            csr.values = csr.values.astype(np.float32)
        label = args.file
    else:
        from scipy import sparse as ssp

        side = args.side
        t = ssp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(side, side))
        lap = (ssp.kron(ssp.eye(side), t) +
               ssp.kron(t, ssp.eye(side))).tocsr()
        csr = CsrMatrix.from_scipy(lap.astype(np.float32))
        label = f"laplacian2d({side}x{side})"
    m, n = csr.shape
    if m != n:
        print(f"solve needs a square system, got {m}x{n}")
        return 2
    s = matrix_stats_csr(csr)
    fmt = auto_format(csr, stats=s)
    print(f"{label}: n={n}, nnz={s['nnz']} -> {type(fmt).__name__}")

    rng = np.random.default_rng(args.seed)
    b = rng.normal(size=n).astype(np.float32)

    # preconditioner STATE rides into the jitted program as an argument
    # (a closure-captured operator would be baked into the program as
    # constants; see amg.py module docs)
    pstate = None
    if args.precond == "jacobi":
        rows = np.repeat(np.arange(n), csr.row_nnz)
        diag = np.zeros(n, np.float32)
        ond = rows == csr.col_idx
        diag[rows[ond]] = csr.values[ond]
        pstate = jnp.asarray(1.0 / (diag + 1e-12))
    elif args.precond == "chebyshev":
        from tpusparse.eig import spectrum_bounds

        lmin, lmax = spectrum_bounds(fmt)
        print(f"spectrum bounds [{float(lmin):.3g}, {float(lmax):.3g}]")
        pstate = (lmin, lmax)
    elif args.precond == "amg":
        from tpusparse.amg import (SmoothedAggregationAMG,
                                   smoothed_aggregation)

        t0 = _time.perf_counter()
        if args.precond_file:
            pstate = SmoothedAggregationAMG.load(args.precond_file)
            print(f"amg load {_time.perf_counter() - t0:.2f}s: {pstate!r}")
        else:
            pstate = smoothed_aggregation(csr, degree=args.degree)
            print(f"amg setup {_time.perf_counter() - t0:.2f}s: {pstate!r}")
        if args.save_precond:
            t0 = _time.perf_counter()
            pstate.save(args.save_precond)
            print(f"amg saved to {args.save_precond} "
                  f"({_time.perf_counter() - t0:.2f}s)")

    solver = {"cg": _solve.cg, "bicgstab": _solve.bicgstab,
              "gmres": _solve.gmres}[args.solver]

    @jax.jit
    def jsolve(fmt_, b_, ps):
        if args.precond == "jacobi":
            m_inv = lambda v: v * ps                        # noqa: E731
        elif args.precond == "chebyshev":
            m_inv = _solve.chebyshev_preconditioner(
                fmt_, ps[1], lmin=ps[0], degree=args.degree)
        elif args.precond == "amg":
            m_inv = lambda r: ps._cycle(0, r)               # noqa: E731
        else:
            m_inv = None
        return solver(fmt_, b_, tol=args.tol, m_inv=m_inv)

    def run():
        t0 = _time.perf_counter()
        z, info = jsolve(fmt, jnp.asarray(b), pstate)
        res = float(info["resnorm"])          # fetch waits for the device
        return z, int(info["iters"]), res, _time.perf_counter() - t0

    _z, _, _, t_cold = run()                  # compile + run
    z, iters, res, t_warm = run()
    rr = np.repeat(np.arange(n), csr.row_nnz)
    az = np.zeros(n, np.float64)
    np.add.at(az, rr, csr.values.astype(np.float64) *
              np.asarray(z, np.float64)[csr.col_idx])
    err = float(np.max(np.abs(az - b)))
    ok = res <= args.tol * float(np.linalg.norm(b)) * 1.01
    print(f"{args.solver}+{args.precond}: {iters} iters, resnorm "
          f"{res:.3e}, {t_warm*1e3:.1f} ms warm ({t_cold:.1f} s cold), "
          f"max|Az-b| {err:.3e} [{'OK' if ok else 'NOT CONVERGED'}]")
    return 0 if ok else 1


def cmd_scaling(args) -> int:
    """Weak/strong scaling efficiency over the available device mesh."""
    if args.model:
        # analytic comm/overlap model (validated against the lowered
        # programs in tests/test_commmodel.py) — the quantitative scaling
        # claim real multi-chip hardware would be checked against
        from tpusparse.bench.commmodel import report

        print(report(m=args.m, n=args.n, batch=args.batch))
        return 0
    from tpusparse.bench.scaling import sweep_scaling

    counts = None if args.devices == "auto" else tuple(
        int(s) for s in args.devices.split(","))
    points = sweep_scaling(mode=args.mode, kernel=args.kernel,
                           partition=args.partition, base_m=args.m,
                           base_n=args.n, density=args.density,
                           device_counts=counts, seed=args.seed)
    worst = min(p.efficiency for p in points)
    print(f"worst efficiency: {worst * 100:.0f}%")
    return 0


def cmd_gallery(args) -> int:
    """Real-topology workload gallery + router-regret benchmark
    (bench/gallery.py): forwards to its own argv."""
    from tpusparse.bench.gallery import main as gmain

    return gmain(args.rest)


def cmd_dynamic(args) -> int:
    """Dynamic-activation serving bench (bench/dynamic.py)."""
    from tpusparse.bench.dynamic import main as dmain

    return dmain(args.rest)


def cmd_scale(args) -> int:
    """GB-scale unstructured run (bench/scale.py)."""
    from tpusparse.bench.scale import main as smain

    return smain(args.rest)


def main(argv=None) -> int:
    import sys as _sys

    argv = list(_sys.argv[1:] if argv is None else argv)
    # bench-module passthrough subcommands (own argparse each; argparse
    # REMAINDER cannot forward leading optionals, so dispatch before it)
    _fwd = {"gallery": cmd_gallery, "dynamic": cmd_dynamic,
            "scale": cmd_scale}
    if argv and argv[0] in _fwd:
        ns = argparse.Namespace(rest=argv[1:])
        return _fwd[argv[0]](ns)
    parser = argparse.ArgumentParser(prog="tpusparse")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name, fn in _fwd.items():
        p = sub.add_parser(name, help=fn.__doc__.splitlines()[0])
    for name, fn in [("check", cmd_check), ("bench", cmd_bench),
                     ("headline", cmd_headline), ("profile", cmd_profile),
                     ("scaling", cmd_scaling),
                     ("mtx", cmd_mtx), ("solve", cmd_solve)]:
        p = sub.add_parser(name)
        if name == "solve":
            p.add_argument("--file", default=None,
                           help="MatrixMarket .mtx path (default: generated "
                                "2-D Laplacian)")
            p.add_argument("--side", type=int, default=128,
                           help="grid side for the generated Laplacian")
            p.add_argument("--solver", default="cg",
                           choices=["cg", "bicgstab", "gmres"])
            p.add_argument("--precond", default="none",
                           choices=["none", "jacobi", "chebyshev", "amg"])
            p.add_argument("--degree", type=int, default=2,
                           help="chebyshev/amg-smoother polynomial degree")
            p.add_argument("--save-precond", default=None, metavar="NPZ",
                           help="with --precond amg: persist the built "
                                "hierarchy (amg.save)")
            p.add_argument("--precond-file", default=None, metavar="NPZ",
                           help="with --precond amg: load a saved "
                                "hierarchy instead of building one")
            p.add_argument("--tol", type=float, default=1e-5)
            p.add_argument("--seed", type=int, default=0)
            p.add_argument("--cpu", action="store_true")
            p.set_defaults(fn=fn)
            continue
        if name == "mtx":
            p.add_argument("file", help="MatrixMarket .mtx path")
            p.add_argument("--batch", type=int, default=1)
            p.add_argument("--x-density", type=float, default=0.5)
            p.add_argument("--seed", type=int, default=0)
            p.add_argument("--no-time", action="store_true",
                           help="stop after the float64-oracle check "
                                "(skip device timing)")
            p.add_argument("--cpu", action="store_true")
            p.set_defaults(fn=fn)
            continue
        _add_workload_args(p)
        if name == "profile":
            p.add_argument("--trace-dir", default="/tmp/tpusparse-trace")
        if name == "bench":
            p.add_argument("--format", default="text",
                           choices=["text", "json", "csv"])
        if name == "scaling":
            p.add_argument("--mode", default="weak",
                           choices=["weak", "strong"])
            p.add_argument("--kernel", default="dense",
                           choices=["dense", "sell"])
            p.add_argument("--partition", default="n",
                           choices=["n", "m", "ring"])
            p.add_argument("--devices", default="auto",
                           help="comma-separated device counts, or 'auto'")
            p.add_argument("--model", action="store_true",
                           help="print the analytic comm/overlap model "
                                "instead of measuring")
        p.set_defaults(fn=fn)
    args = parser.parse_args(argv)
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    # Persistent compile cache: repeated bench runs re-lower the same
    # programs; warm reruns skip the compiles.
    from tpusparse.utils.platform import enable_compile_cache

    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
