"""Benchmark suites: headline (driver-facing) and full kernel sweep."""

from __future__ import annotations

from typing import Any

from tpusparse.bench.roofline import format_bytes, roofline_fraction
from tpusparse.bench.runner import BenchResult, device_time
from tpusparse.config import SpmvConfig
from tpusparse.testing import generators


def _canonical_workload(cfg: SpmvConfig):
    a = generators.random_sparse_matrix(cfg.m, cfg.n, density=cfg.density,
                                        seed=cfg.seed,
                                        distribution=cfg.distribution)
    x = generators.random_sparse_vector(cfg.m, density=cfg.x_density,
                                        seed=cfg.seed)
    return a, x


def registry(full: bool = True) -> list[dict[str, Any]]:
    """Benchable kernels: name, prepare(dense)->fmt, run(fmt,x)->y.

    ``full=False`` returns the lean headline set (dense baselines + the SELL
    flagship) used by bench.py; the CLI ``bench`` command runs everything.
    The reference hard-coded its registry (tester.cpp:54-63); this one is
    selectable (see cli.py --kernels).
    """
    from tpusparse.kernels.dense import dense_xla

    def fmt_run(f, x):
        return f.spmv(x) if x.ndim == 1 else f.spmm(x)

    def full_plan_run(f, x):
        # activation-skip formats under the (jitted) timing chain: the
        # i.i.d. benchmark semantics IS the visit-everything plan, so pass
        # it explicitly instead of tripping the traced-plan warning
        plan = f._full_plan()
        return f.spmv(x, plan=plan) if x.ndim == 1 else f.spmm(x, plan=plan)

    entries = [
        dict(name="dense_xla", prepare=lambda a: a,
             run=lambda f, x: dense_xla(f, x)),
    ]
    from tpusparse.formats.sell import SellMatrix

    entries.append(dict(
        name="sell",
        prepare=lambda a: SellMatrix.from_dense(a),
        run=fmt_run,
    ))
    from tpusparse.formats.awsp import AwspMatrix

    entries.append(dict(
        name="awsp",
        # g=8 pinned: the canonical workload is static full-live X, where
        # coarser skip groups mean fewer plan entries. The format's g=1
        # DEFAULT targets dynamic serving.
        prepare=lambda a: AwspMatrix.from_dense(a, g=8),
        run=full_plan_run,
    ))
    if not full:
        return entries

    from tpusparse.formats.binned import BinnedSellMatrix
    from tpusparse.formats.bsr import BsrMatrix
    from tpusparse.formats.ell import EllMatrix
    from tpusparse.formats.rsell import RsellMatrix
    from tpusparse.formats.tcsr import TcsrMatrix
    from tpusparse.kernels.asp_spmv import AspMatrix

    entries += [
        dict(name="ell_xla",
             prepare=lambda a: EllMatrix.from_dense(a),
             run=fmt_run),
        dict(name="sell_binned",
             prepare=lambda a: BinnedSellMatrix.from_dense(a),
             run=fmt_run),
        dict(name="bsr",
             prepare=lambda a: BsrMatrix.from_dense(a, block_m=512),
             run=fmt_run),
        dict(name="tcsr",
             prepare=lambda a: TcsrMatrix.from_dense(a),
             run=fmt_run),
        dict(name="rsell",
             prepare=lambda a: RsellMatrix.from_dense(a),
             run=fmt_run),
        dict(name="asp",
             prepare=lambda a: AspMatrix.from_dense(a),
             run=full_plan_run),
    ]
    return entries


def sweep(cfg: SpmvConfig | None = None, verbose: bool = True,
          full: bool = True,
          entries: list[dict[str, Any]] | None = None) -> list[BenchResult]:
    """Bench registered kernels on the configured workload."""
    cfg = cfg or SpmvConfig()
    a, x = _canonical_workload(cfg)
    nnz = int((a != 0).sum())
    flops = 2 * nnz
    results = []
    for e in entries if entries is not None else registry(full=full):
        fmt = e["prepare"](a)
        nbytes = format_bytes(fmt)
        r = device_time(e["run"], fmt, x, name=e["name"],
                        bytes_moved=nbytes, flops=flops, nnz=nnz)
        results.append(r)
        if verbose:
            frac = roofline_fraction(nbytes, r.seconds)
            print(f"{r} | {frac*100:.0f}% of the memory roofline on its "
                  "own bytes")
    return results


def headline() -> dict[str, Any]:
    """One JSON-able dict for the driver: best kernel vs dense baseline."""
    cfg = SpmvConfig()
    results = sweep(cfg, verbose=False, full=False)
    dense = next(r for r in results if r.name == "dense_xla")
    best = min(results, key=lambda r: r.seconds)
    return {
        "metric": f"spmv_nnz_per_s[{best.name}] M=N=4096 d=0.5 fp32",
        "value": round(best.nnz_per_s / 1e9, 3),
        "unit": "Gnnz/s",
        "vs_baseline": round(dense.seconds / best.seconds, 3),
        "detail": {
            r.name: {
                "us": round(r.seconds * 1e6, 1),
                "gbps": round(r.gbps, 1) if r.gbps else None,
                "roofline_frac": round(
                    roofline_fraction(r.bytes_moved, r.seconds), 3),
            }
            for r in results
        },
        "device": device_stamp(),
    }


def device_stamp() -> dict[str, Any]:
    """What the numbers were measured on: JAX's device kind and count, and
    the card's name and power limit as ``nvidia-smi`` reports them (a card
    set below its maximum power runs slower under load)."""
    import subprocess

    import jax

    d = jax.devices()[0]
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        smi = []
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()),
            "nvidia_smi": smi[0] if smi else None}
