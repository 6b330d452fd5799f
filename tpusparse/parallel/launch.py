"""Multi-host launch helpers.

SURVEY.md §2.4 plans a "multi-host launcher: ``jax.distributed.initialize()``
+ ``jax.process_index()``-aware data gen" with no reference counterpart (the
reference is single-GPU). These helpers are the environment-side glue: call
``initialize()`` once per process before touching devices, then build the
global mesh and generate only this process's slab of the operand.
"""

from __future__ import annotations

import os

import numpy as np

import jax

from tpusparse.parallel.mesh import make_mesh

_LOCAL_HOSTS = ("localhost", "127.0.0.1", "::1", "[::1]")


def local_devices(coordinator_address: str | None,
                  num_processes: int | None, process_id: int | None,
                  local_device_ids: int | list[int] | None = None
                  ) -> int | list[int] | None:
    """The cards this process opens; None opens every visible card.

    A JAX process reserves most of every card it opens, so a second
    process on the same card fails for want of memory. Hence, when several
    processes are launched and neither ``local_device_ids`` nor the
    launcher's ``CUDA_VISIBLE_DEVICES`` / ``JAX_LOCAL_DEVICE_IDS`` names
    the cards, each process takes the one card of its local rank:
    ``LOCAL_RANK`` when the launcher sets it, else ``process_id`` when the
    coordinator is on this host (every process then shares it). A
    multi-host launch with one process per host keeps all its cards.
    """
    if local_device_ids is not None:
        return local_device_ids
    if (os.environ.get("CUDA_VISIBLE_DEVICES")
            or os.environ.get("JAX_LOCAL_DEVICE_IDS")
            or not num_processes or num_processes < 2):
        return None
    if os.environ.get("LOCAL_RANK"):
        return int(os.environ["LOCAL_RANK"])
    host = (coordinator_address or "").rsplit(":", 1)[0]
    if process_id is not None and host in _LOCAL_HOSTS:
        return process_id
    return None


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids: int | list[int] | None = None) -> None:
    """Idempotent ``jax.distributed.initialize`` (env-driven when args are
    None; a cluster scheduler may provide all three).

    ``local_device_ids``: the cards this process drives; the default gives
    each of several processes on one host its own card (``local_devices``).

    MUST run before anything touches devices: even ``jax.process_count()``
    initializes the XLA backend, after which distributed init raises. The
    idempotency check therefore inspects the distributed client directly
    instead of calling any device API, and a too-late call is surfaced as
    an error rather than silently degrading every host to single-process.
    """
    try:
        # private API (no stability guarantee) — used only for the
        # idempotency fast path; when it disappears we fall through to the
        # exception-tolerant initialize below
        from jax._src import distributed as _dist

        if _dist.global_state.client is not None:  # already initialized
            return
    except (ImportError, AttributeError):
        pass
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id,
                                   local_device_ids=local_devices(
                                       coordinator_address, num_processes,
                                       process_id, local_device_ids))
    except ValueError:
        # no coordinator configured anywhere -> single-process run
        pass
    except RuntimeError as e:
        if "already initialized" in str(e).lower():
            return                                # idempotent re-call
        wants_multi = any(v is not None for v in (
            coordinator_address, num_processes, process_id)) or \
            os.environ.get("JAX_COORDINATOR_ADDRESS") or \
            os.environ.get("COORDINATOR_ADDRESS")
        if wants_multi:
            raise RuntimeError(
                "tpusparse.parallel.initialize() must be called before any "
                "JAX device/backend use (it cannot initialize multi-host "
                "after the XLA backend has started)") from e
        # single-process with the backend already up — harmless


def global_mesh(axis_name: str = "n"):
    """1-D mesh over every device of every process."""
    return make_mesh({axis_name: len(jax.devices())})


def process_slab(m: int, n: int, *, partition: str = "n",
                 process_index: int | None = None,
                 process_count: int | None = None) -> tuple[slice, slice]:
    """This process's (row, col) slab of the global (m, n) operand.

    With ``partition='n'`` hosts split the output dim; with ``'m'`` the
    contraction dim. Generation stays reproducible across launches because
    every host uses the same global seed and simply slices its slab
    (tester semantics: one logical global matrix).
    """
    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    if partition == "n":
        if n % pc:
            raise ValueError(f"n={n} not divisible by {pc} processes")
        step = n // pc
        return slice(0, m), slice(pi * step, (pi + 1) * step)
    if partition == "m":
        if m % pc:
            raise ValueError(f"m={m} not divisible by {pc} processes")
        step = m // pc
        return slice(pi * step, (pi + 1) * step), slice(0, n)
    raise ValueError(f"unknown partition {partition!r}")


def host_local_matrix(m: int, n: int, *, density: float = 0.5, seed: int = 0,
                      partition: str = "n", distribution: str = "uniform",
                      **slab_kw) -> np.ndarray:
    """This process's slab of the seeded global matrix (same seed on every
    host -> slabs tile one logical matrix, like a single-host run)."""
    from tpusparse.testing import generators

    a = generators.random_sparse_matrix(m, n, density=density, seed=seed,
                                        distribution=distribution)
    rs, cs = process_slab(m, n, partition=partition, **slab_kw)
    return a[rs, cs]
