"""Integration-test / benchmark harness.

Re-design of ``SparseSgemvTester`` (tester.{hpp,cpp}):

- seeded generators instead of ``std::random_device`` (tester.cpp:107);
- a *configurable* kernel registry instead of the hard-coded list
  (tester.cpp:54-63; SURVEY.md §3.1 explicitly asks for this);
- hard-failing comparison — the reference printed mismatches but never failed
  (``exit`` commented out, tester.cpp:83); here ``check()`` returns a report
  and ``run()`` raises on mismatch unless told otherwise;
- timing is opt-in and separated from correctness (SURVEY.md §4).

A "kernel" here is ``prepare(a_dense) -> fmt`` (host-side converter, excluded
from timing like the reference launchers exclude conversion, awsp.cu:323 vs
:346) plus ``run(fmt, x) -> y`` (jitted device compute).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np

from tpusparse.config import SpmvConfig
from tpusparse.testing import generators, reference
from tpusparse.utils.timing import TimingResult, time_fn, time_fn_amortized


@dataclasses.dataclass
class KernelEntry:
    name: str
    prepare: Callable[[np.ndarray], Any]          # dense A -> device format
    run: Callable[[Any, Any], Any]                # (fmt, x) -> y  (jitted)
    supports_batch: bool = True


@dataclasses.dataclass
class CompareReport:
    name: str
    max_abs_err: float
    num_mismatch: int
    atol: float
    timing: TimingResult | None = None

    @property
    def ok(self) -> bool:
        return self.num_mismatch == 0

    def __str__(self) -> str:
        status = "OK" if self.ok else f"FAIL ({self.num_mismatch} elems > {self.atol})"
        line = f"[{self.name}] max|err|={self.max_abs_err:.3e} {status}"
        if self.timing is not None:
            line += f" | {self.timing}"
        return line


class SpmvTester:
    """Generates a workload, runs registered kernels, compares to the oracle."""

    def __init__(self, config: SpmvConfig | None = None):
        self.config = config or SpmvConfig()
        self._registry: list[KernelEntry] = []
        c = self.config
        self.a = generators.random_sparse_matrix(
            c.m, c.n, density=c.density, seed=c.seed, distribution=c.distribution
        )
        if c.batch == 1:
            self.x = generators.random_sparse_vector(
                c.m, density=c.x_density, seed=c.seed
            )
            self.y_ref = reference.sgemv_cpu(self.x, self.a)
        else:
            self.x = generators.random_sparse_batch(
                c.batch, c.m, density=c.x_density, seed=c.seed
            )
            self.y_ref = reference.sgemm_cpu(self.x, self.a)

    def register(self, entry: KernelEntry) -> None:
        self._registry.append(entry)

    @property
    def kernel_names(self) -> list[str]:
        return [e.name for e in self._registry]

    def check(self, entry: KernelEntry, time_it: bool = False,
              warmup: int = 2, iters: int = 10,
              amortized: bool = True) -> CompareReport:
        import jax

        # Device-resident operands: conversion + H2D are excluded from the
        # timed region, exactly like the reference launchers (awsp.cu:323
        # converts and copies before TIME_KERNEL at awsp.cu:346).
        fmt = jax.device_put(entry.prepare(self.a))
        x_dev = jax.device_put(self.x)
        y = np.asarray(entry.run(fmt, x_dev))
        err = np.abs(y.astype(np.float64) - self.y_ref.astype(np.float64))
        timing = None
        if time_it:
            if amortized:
                timing = time_fn_amortized(entry.run, fmt, x_dev,
                                           name=entry.name)
            else:
                timing = time_fn(entry.run, fmt, x_dev, name=entry.name,
                                 warmup=warmup, iters=iters)
        return CompareReport(
            name=entry.name,
            max_abs_err=float(err.max()) if err.size else 0.0,
            num_mismatch=int((err > self.config.atol).sum()),
            atol=self.config.atol,
            timing=timing,
        )

    def run(self, time_it: bool = False, raise_on_fail: bool = True,
            verbose: bool = True) -> list[CompareReport]:
        reports = []
        for entry in self._registry:
            rep = self.check(entry, time_it=time_it)
            reports.append(rep)
            if verbose:
                print(rep)
        failures = [r for r in reports if not r.ok]
        if failures and raise_on_fail:
            names = ", ".join(r.name for r in failures)
            raise AssertionError(f"kernels failed tolerance check: {names}")
        return reports
