"""Scaling-efficiency benchmark over an N-device mesh.

BASELINE.md target: >=90% weak-scaling efficiency at 4 cards. The
reference has no distributed code at all (SURVEY.md §2.4), so these curves
are a new capability. On a multi-card host this measures the interconnect;
elsewhere it runs on however many devices exist (the test env forces an
8-device virtual CPU mesh, which validates the sharded program end-to-end
and gives a logical scaling curve — real link numbers require real cards).

Timing goes through the slope-method runner (bench/runner.py) like every
other perf number in this repo: operands are pre-placed with the partition's
NamedSharding so the timed region contains no resharding, and iterations are
chained inside one jit so dispatch cost cancels.

Definitions (D = device count, T_D = per-call device time on D devices,
D0 = the first measured device count):
- weak scaling: per-device work held constant (the sharded dim grows with
  D); efficiency_D = T_D0 / T_D          (ideal: 1.0)
- strong scaling: total work held constant;
  efficiency_D = (D0 * T_D0) / (D * T_D) (ideal: 1.0)
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from tpusparse.bench.runner import device_time
from tpusparse.parallel import make_mesh
from tpusparse.testing import generators

_LANES = 128


@dataclasses.dataclass
class ScalePoint:
    devices: int
    m: int
    n: int
    seconds: float
    efficiency: float | None = None

    def __str__(self) -> str:
        eff = "" if self.efficiency is None else \
            f" | eff {self.efficiency * 100:.0f}%"
        return (f"D={self.devices} ({self.m}x{self.n}): "
                f"{self.seconds * 1e6:.0f} us{eff}")


def _placed(mesh, spec, value):
    return jax.device_put(jnp.asarray(value), NamedSharding(mesh, spec))


def _prepare(a: np.ndarray, x: np.ndarray, mesh, partition: str,
             kernel: str):
    """(fmt, x_placed, fn, bytes) with operands pre-placed per partition."""
    if kernel == "sell":
        from tpusparse.formats.sell import SellMatrix
        from tpusparse.parallel.sparse import sell_spmm_sharded

        s = SellMatrix.from_dense(a)
        leaf_spec = {"n": P("n"), "m": P(None, "n"),
                     "ring": P("n")}[partition]
        x_spec = {"n": P(), "m": P("n"), "ring": P("n")}[partition]
        fmt = SellMatrix(_placed(mesh, leaf_spec, s.idx),
                         _placed(mesh, leaf_spec, s.vals),
                         s.shape, s.padded, s.w, s.nnz)
        fn = lambda f, xx: sell_spmm_sharded(f, xx, mesh, partition)  # noqa: E731
        nbytes = s.device_bytes()
    else:
        from tpusparse.parallel import spmv_sharded

        a_spec = {"n": P(None, "n"), "m": P("n", None),
                  "ring": P(None, "n")}[partition]
        x_spec = {"n": P(), "m": P("n"), "ring": P("n")}[partition]
        fmt = _placed(mesh, a_spec, a)
        fn = lambda f, xx: spmv_sharded(f, xx, mesh=mesh, partition=partition)  # noqa: E731
        nbytes = a.nbytes
    xp = _placed(mesh, x_spec, x)
    return fmt, xp, fn, nbytes


def sweep_scaling(
    *,
    mode: str = "weak",                 # "weak" | "strong"
    kernel: str = "dense",              # "dense" | "sell"
    partition: str = "n",
    base_m: int = 1024,
    base_n: int = 1024,
    density: float = 0.5,
    device_counts: tuple[int, ...] | None = None,
    seed: int = 0,
    verbose: bool = True,
    reps: int = 5,
    k1: int | None = None,
    k2: int | None = None,
) -> list[ScalePoint]:
    all_devices = jax.devices()
    if k1 is None or k2 is None:
        # CPU (heavy shard_map compiles): short chains; real cards: long
        # chains so the slope dominates dispatch jitter (bench/runner.py)
        cpu = all_devices[0].platform == "cpu"
        k1 = (4 if cpu else 16) if k1 is None else k1
        k2 = (20 if cpu else 272) if k2 is None else k2
    if device_counts is None:
        # auto counts must respect the partition's divisibility (strong mode
        # keeps the sharded dim fixed, so e.g. sell/'n' needs base_n/128
        # divisible by D) — filter instead of crashing mid-sweep
        def _fits(d: int) -> bool:
            if mode == "weak":      # sharded dim grows with d
                return True
            sharded = base_n if partition in ("n", "ring") else base_m
            quantum = _LANES if kernel == "sell" else 1
            if partition == "ring":     # both dims shard
                return (base_n // quantum) % d == 0 and \
                    (base_m // quantum) % d == 0
            return (sharded // quantum) % d == 0 and sharded % d == 0

        device_counts = tuple(
            d for d in (1, 2, 4, 8, 16, 32)
            if d <= len(all_devices) and _fits(d))
    points: list[ScalePoint] = []
    for d in device_counts:
        if mode == "weak":
            # grow the sharded dim with D: per-device slab constant
            m, n = (base_m, base_n * d) if partition == "n" \
                else (base_m * d, base_n)
        else:
            m, n = base_m, base_n
        a = generators.random_sparse_matrix(m, n, density=density, seed=seed)
        x = generators.random_sparse_vector(m, density=density, seed=seed)
        mesh = make_mesh({"n": d}, all_devices[:d])
        fmt, xp, fn, nbytes = _prepare(a, x, mesh, partition, kernel)
        r = device_time(fn, fmt, xp, name=f"D={d}", bytes_moved=nbytes,
                        reps=reps, k1=k1, k2=k2)
        points.append(ScalePoint(devices=d, m=m, n=n, seconds=r.seconds))
    d0, t0 = points[0].devices, points[0].seconds
    for p in points:
        p.efficiency = t0 / p.seconds if mode == "weak" \
            else (d0 * t0) / (p.devices * p.seconds)
    if verbose:
        for p in points:
            print(f"[{mode}/{kernel}/{partition}] {p}")
        if all_devices[0].platform == "cpu":
            print("note: virtual CPU devices share one host's cores — "
                  "efficiency here validates the sharded program, not "
                  "hardware scaling (D devices = D x the work on the same "
                  "silicon, so weak efficiency trends toward 1/D); the "
                  ">=90% target applies on real multi-chip meshes.")
    return points
