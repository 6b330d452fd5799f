"""Multi-host launch helpers (single-process semantics + slab math), plus a
real 2-process ``jax.distributed`` run over localhost."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from tpusparse.parallel import launch
from tpusparse.testing import generators


def test_initialize_single_process_noop():
    launch.initialize()          # must not raise without a coordinator
    import jax

    assert jax.process_count() == 1


def test_global_mesh_covers_all_devices():
    import jax

    mesh = launch.global_mesh()
    assert mesh.devices.size == len(jax.devices())


@pytest.mark.parametrize("partition", ["n", "m"])
def test_slabs_tile_the_global_matrix(partition):
    m, n = 256, 512
    a = generators.random_sparse_matrix(m, n, density=0.5, seed=11)
    slabs = [
        launch.host_local_matrix(m, n, density=0.5, seed=11,
                                 partition=partition,
                                 process_index=i, process_count=4)
        for i in range(4)
    ]
    axis = 1 if partition == "n" else 0
    np.testing.assert_array_equal(np.concatenate(slabs, axis=axis), a)


def test_slab_divisibility_error():
    with pytest.raises(ValueError):
        launch.process_slab(100, 100, partition="n",
                            process_index=0, process_count=3)


def test_two_process_distributed_spmv():
    """2 OS processes x 2 virtual CPU devices: jax.distributed.initialize
    through launch.initialize(), host_local_matrix slab agreement, and
    dense n/m + SELL n sharded SpMV across the process boundary — the
    multi-host path SURVEY.md §2.4 promises."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tests", "distributed_worker.py")
    # EXTEND PYTHONPATH (overwriting it would drop whatever site setup the
    # parent environment carries)
    env = {**os.environ,
           "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    env.pop("XLA_FLAGS", None)               # worker sets its own
    procs = [subprocess.Popen(
        [sys.executable, worker, str(port), str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=root) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=150)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"WORKER-OK {i}" in out, f"worker {i} output:\n{out}"


@pytest.mark.parametrize("coord, nproc, pid, given, env, want", [
    ("localhost:1234", 4, 2, None, {}, 2),          # one host: own card
    ("127.0.0.1:1234", 2, 1, None, {}, 1),
    ("10.0.0.7:1234", 4, 2, None, {}, None),        # a host each: all cards
    ("10.0.0.7:1234", 8, 5, None, {"LOCAL_RANK": "1"}, 1),
    ("localhost:1234", 4, 2, [3], {}, [3]),         # explicit ids win
    ("localhost:1234", 4, 2, None, {"CUDA_VISIBLE_DEVICES": "2"}, None),
    ("localhost:1234", 4, 2, None, {"JAX_LOCAL_DEVICE_IDS": "2"}, None),
    ("localhost:1234", 1, 0, None, {}, None),       # one process
    (None, None, None, None, {}, None),             # env-driven launch
])
def test_local_devices_one_card_per_process(monkeypatch, coord, nproc, pid,
                                            given, env, want):
    for k in ("CUDA_VISIBLE_DEVICES", "JAX_LOCAL_DEVICE_IDS", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert launch.local_devices(coord, nproc, pid, given) == want


def test_initialize_passes_the_local_card(monkeypatch):
    import jax

    seen = {}
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.delenv("JAX_LOCAL_DEVICE_IDS", raising=False)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    launch.initialize(coordinator_address="localhost:1234", num_processes=4,
                      process_id=3)
    assert seen["local_device_ids"] == 3


def test_initialize_late_multihost_raises():
    """Explicit multi-host args after backend init must fail loudly, not
    silently degrade every host to single-process."""
    import jax

    jax.devices()                    # ensure backend is up
    with pytest.raises(RuntimeError, match="before any JAX"):
        launch.initialize(coordinator_address="127.0.0.1:9999",
                          num_processes=2, process_id=0)
