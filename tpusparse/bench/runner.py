"""Device-time measurement by the slope of chained calls.

Replaces the reference's ``TIME_KERNEL`` cudaEvent macro (kernel.hpp:31-48)
with a host-clock measurement that needs no device events. We measure the
*slope*:

    T(k)  = overhead + k * t_kernel      (k chained in-jit iterations)
    t_kernel = (T(k2) - T(k1)) / (k2 - k1)

with three safeguards:

- iterations are data-chained through ``eps = sum(y) * 1e-37`` (numerically a
  no-op in fp32, but XLA cannot fold it, so the chain cannot be hoisted);
- iterations cycle over enough on-device operand replicas that several
  times the largest on-chip cache of other traffic separates two uses of the
  same replica, so none stays cache-resident; replicas are made by
  on-device ``jnp.copy`` from a single upload;
- the iteration loop is *statically unrolled* (each replica is a distinct
  jit argument), so no dynamic slice materializes an extra copy.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from tpusparse.bench.roofline import detect_hbm_gbps, device_peaks


def device_memory_bytes(device=None) -> int:
    """Bytes the runtime lets this process allocate on ``device``."""
    d = device if device is not None else jax.devices()[0]
    stats = d.memory_stats() or {}
    if "bytes_limit" not in stats:
        raise RuntimeError(f"{d} reports no memory limit")
    return int(stats["bytes_limit"])


def run_id() -> str:
    """Stamp identifying one bench session: device kind + wall date-hour.
    Every regenerated table/JSON row carries it, so a reader can tell
    which numbers came from the same session."""
    kind = getattr(jax.devices()[0], "device_kind", "cpu").replace(" ", "")
    return f"{kind}-{time.strftime('%Y%m%d-%H%M')}"


@dataclasses.dataclass
class BenchResult:
    name: str
    seconds: float           # per-call device time
    bytes_moved: int | None = None  # format bytes actually streamed
    flops: int | None = None
    nnz: int | None = None

    @property
    def gbps(self) -> float | None:
        return None if self.bytes_moved is None else self.bytes_moved / self.seconds / 1e9

    @property
    def gflops(self) -> float | None:
        return None if self.flops is None else self.flops / self.seconds / 1e9

    @property
    def nnz_per_s(self) -> float | None:
        return None if self.nnz is None else self.nnz / self.seconds

    def __str__(self) -> str:
        parts = [f"{self.name}: {self.seconds*1e6:.1f} us"]
        if self.gbps is not None:
            parts.append(f"{self.gbps:.0f} GB/s")
        if self.gflops is not None:
            parts.append(f"{self.gflops:.1f} GFLOP/s")
        if self.nnz_per_s is not None:
            parts.append(f"{self.nnz_per_s/1e9:.2f} Gnnz/s")
        return " | ".join(parts)


def _replicate(fmt: Any, copies: int) -> list[Any]:
    """``copies`` independent device-resident replicas of a format pytree.

    The host->device transfer happens ONCE; the remaining replicas are
    produced by on-device ``jnp.copy``, which gives distinct device buffers
    without another upload.
    """
    base = jax.tree_util.tree_map(
        lambda leaf: jax.device_put(jnp.asarray(leaf)), fmt)
    out = [base]
    for _ in range(copies - 1):
        out.append(jax.tree_util.tree_map(lambda l: jnp.copy(l), base))
    return out


def _chained(fn: Callable[[Any, Any], Any], k: int):
    """jit of k sequential fn calls cycling over the operand replicas.

    The replica pool is sized (see ``device_time``) so that two uses of the
    same replica are separated by more traffic than the on-chip cache
    holds, making every iteration stream from device memory.
    """

    @jax.jit
    def run(replicas, x):
        y = fn(replicas[0], x)
        for i in range(1, k):
            eps = (jnp.sum(y) * 1e-37).astype(x.dtype)
            y = fn(replicas[i % len(replicas)], x + eps)
        return jnp.sum(y)

    return run


def chain_device_time(
    chain_of: Callable[[int], Callable[..., Any]],
    *args: Any,
    name: str = "chain",
    k1: int = 8,
    k2: int | None = None,
    reps: int = 7,
    bytes_moved: int | None = None,
    flops: int | None = None,
    nnz: int | None = None,
) -> BenchResult:
    """Slope timing for a caller-built iteration chain.

    For workloads that cannot cycle a replica pool — e.g. a training step
    whose params are DELIBERATELY device-resident across iterations, exactly
    as in a real training loop — the caller provides ``chain_of(k)``
    returning a jitted function of ``*args`` that runs k data-chained
    iterations and reduces to a scalar. The per-iteration device time is the
    median over ``reps`` of the paired slopes (T(k2)-T(k1))/(k2-k1); the
    median pairs each rep's totals so dispatch jitter enters as a zero-mean
    difference (same rationale as ``device_time``'s "median" estimator). Keep (k2-k1) x expected-iteration-time >= ~10 ms: with
    ``k2=None`` and ``bytes_moved`` given, k2 auto-scales so the span
    carries >= ~10 ms of speed-of-light work (capped at 576 to bound the
    unrolled chain's compile cost), mirroring ``device_time``; pass k2
    explicitly for chains whose per-iteration cost bytes can't predict
    (compute-bound cycles).
    """
    if k2 is None:
        est = None if (bytes_moved is None
                       or jax.default_backend() == "cpu") \
            else bytes_moved / (detect_hbm_gbps() * 1e9)
        k2 = 168 if est is None else int(
            min(576, max(168, k1 + 10e-3 / max(est, 1e-9))))
    run1, run2 = chain_of(k1), chain_of(k2)
    float(run1(*args))  # compile + sync
    float(run2(*args))
    slopes = []
    for _ in range(reps):
        t0 = time.perf_counter()
        float(run1(*args))
        t1 = time.perf_counter()
        float(run2(*args))
        t2 = time.perf_counter()
        slopes.append(((t2 - t1) - (t1 - t0)) / (k2 - k1))
    slopes.sort()
    sec = max(slopes[len(slopes) // 2], 1e-9)
    return BenchResult(name=name, seconds=sec, bytes_moved=bytes_moved,
                       flops=flops, nnz=nnz)


def device_time(
    fn: Callable[[Any, Any], Any],
    fmt: Any,
    x: Any,
    *,
    name: str = "kernel",
    k1: int = 16,
    k2: int | None = None,
    reps: int = 9,
    bytes_moved: int | None = None,
    flops: int | None = None,
    nnz: int | None = None,
    estimator: str | None = None,
) -> BenchResult:
    """Per-call device seconds for ``fn(fmt, x)`` via the slope method.

    ``estimator="min"``: slope between the min-over-reps totals — right when
    the chained device time dominates the dispatch overhead, because
    contention and host noise only ever ADD time.
    ``estimator="median"``: median of the per-rep slopes — right for small
    workloads where k2 x t_kernel is comparable to the host jitter; min-min
    can then pair a lucky-low T(k2) with a normal T(k1) and return a slope
    below the physical roofline. Median pairs each rep's totals, so jitter
    enters as a zero-mean difference and the median suppresses it.

    Defaults (``k2=None``, ``estimator=None``): when ``bytes_moved`` is
    known, the chain is scaled so the k1->k2 span carries >= ~8 ms of
    speed-of-light device work (capped at 576 calls to bound the unrolled
    jit's trace/compile cost) and the estimator switches to "median" when
    even the scaled span stays under ~12 ms. Unknown byte counts keep the
    historical 272/"min" behavior.
    """
    # The speed-of-light estimate only applies on a device with published
    # peaks; on CPU keep the historical 272/"min".
    on_device = jax.default_backend() != "cpu"
    peaks = device_peaks() if on_device else None
    est_call = None if (bytes_moved is None or not on_device) \
        else bytes_moved / (peaks["hbm_gbps"] * 1e9)
    if k2 is None:
        k2 = 272 if est_call is None else int(
            min(576, max(272, k1 + 8e-3 / max(est_call, 1e-9))))
    if estimator is None:
        estimator = "min" if est_call is None or (
            (k2 - k1) * est_call >= 12e-3) else "median"
    # Enough cycled replicas that well over the largest on-chip cache of
    # other traffic passes between two uses of the same replica, so none
    # stays cache-resident; capped at k2 (beyond that every iteration has
    # its own copy anyway).
    pool = 640_000_000 if peaks is None else 12 * peaks["cache_bytes"]
    copies = 6 if bytes_moved is None else max(
        6, -(-pool // max(bytes_moved, 1)))
    if bytes_moved and on_device:
        # GB-scale formats: the pool must also FIT — cap total replica
        # residency at ~70% of the device memory
        copies = min(copies, max(2, int(0.7 * device_memory_bytes()
                                        // bytes_moved)))
    replicas = _replicate(fmt, min(k2, copies))
    x = jax.device_put(jnp.asarray(x))
    run1 = _chained(fn, k1)
    run2 = _chained(fn, k2)
    float(run1(replicas, x))  # compile + sync
    float(run2(replicas, x))
    # Contention and host jitter only ever ADD time, so the clean estimate
    # of each total is the MIN over reps, and the slope comes from the two
    # minima.
    t1s, t2s = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        float(run1(replicas, x))
        t1 = time.perf_counter()
        float(run2(replicas, x))
        t2 = time.perf_counter()
        t1s.append(t1 - t0)
        t2s.append(t2 - t1)
    if estimator == "median":
        slopes = sorted((b - a) / (k2 - k1) for a, b in zip(t1s, t2s))
        sec = max(slopes[len(slopes) // 2], 1e-9)
    else:
        sec = max((min(t2s) - min(t1s)) / (k2 - k1), 1e-9)
    return BenchResult(name=name, seconds=sec, bytes_moved=bytes_moved,
                       flops=flops, nnz=nnz)
