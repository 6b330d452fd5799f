"""Kernel timing: warmup + median-of-k wall time around ``block_until_ready``.

Replacement for the reference's ``TIME_KERNEL`` cudaEvent macro
(src/include/kernel.hpp:31-48). Like the reference, only the device compute is
timed — format conversion and host<->device transfer are excluded (launchers
excluded them too, e.g. awsp.cu:340-346): callers pass already-device-resident
arrays and a pre-jitted function.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, Sequence


@dataclasses.dataclass
class TimingResult:
    name: str
    times_s: list[float]

    @property
    def median_s(self) -> float:
        return statistics.median(self.times_s)

    @property
    def min_s(self) -> float:
        return min(self.times_s)

    @property
    def median_ms(self) -> float:
        return self.median_s * 1e3

    def __str__(self) -> str:  # reference prints "<call> took X ms"
        return f"{self.name} took {self.median_ms:.4f} ms (median of {len(self.times_s)})"


def _block(x: Any) -> None:
    for leaf in _leaves(x):
        if hasattr(leaf, "block_until_ready"):
            leaf.block_until_ready()


def _leaves(x: Any):
    import jax

    return jax.tree_util.tree_leaves(x)


def time_fn(
    fn: Callable[..., Any],
    *args: Any,
    name: str = "kernel",
    warmup: int = 2,
    iters: int = 10,
) -> TimingResult:
    """Time ``fn(*args)`` with warmup (compile) runs then median-of-``iters``."""
    for _ in range(max(warmup, 1)):
        _block(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _block(fn(*args))
        times.append(time.perf_counter() - t0)
    return TimingResult(name=name, times_s=times)


def _looped(fn: Callable[[Any, Any], Any], k: int) -> Callable[[Any, Any], Any]:
    """Chain ``k`` sequential evaluations of ``fn(fmt, x)`` inside one jit.

    Each iteration perturbs ``x`` by a zero derived from the previous result,
    so XLA cannot CSE or reorder the chain; the added cost is one scalar
    broadcast per iteration (negligible against memory traffic).
    """
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(fmt, x):
        def body(_, y):
            # 1e-37 * sum(y) underflows to ~0 in fp32 (x + eps == x after
            # rounding) but XLA cannot prove that, so the chain is preserved.
            # A literal `* 0` gets constant-folded and the loop hoisted.
            eps = (jnp.sum(y) * 1e-37).astype(x.dtype)
            return fn(fmt, x + eps)

        return jax.lax.fori_loop(0, k - 1, body, fn(fmt, x))

    return run


def time_fn_amortized(
    fn: Callable[[Any, Any], Any],
    fmt: Any,
    x: Any,
    name: str = "kernel",
    k: int = 50,
    warmup: int = 1,
    iters: int = 5,
) -> TimingResult:
    """Per-call device time free of host dispatch overhead.

    Measures ``k`` and ``2k`` chained in-jit iterations and reports the slope
    ``(T2 - T1) / k`` — the constant per-launch overhead cancels exactly.
    The analog of the reference timing a bare kernel launch between
    cudaEvents
    (kernel.hpp:31-48) without the surrounding cudaMemcpys.
    """
    run1, run2 = _looped(fn, k), _looped(fn, 2 * k)
    for _ in range(max(warmup, 1)):
        _block(run1(fmt, x))
        _block(run2(fmt, x))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _block(run1(fmt, x))
        t1 = time.perf_counter()
        _block(run2(fmt, x))
        t2 = time.perf_counter()
        times.append(((t2 - t1) - (t1 - t0)) / k)
    # guard against jitter producing a negative slope on tiny kernels
    times = [max(t, 0.0) for t in times]
    return TimingResult(name=name, times_s=times)
