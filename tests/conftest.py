"""Test env: force an 8-device virtual CPU mesh before JAX initializes.

SURVEY.md §4: multi-host logic is tested on a fake backend —
``xla_force_host_platform_device_count=8`` + CPU mesh. Tests that need the
GPU carry the ``gpu`` marker and skip here; a hand kernel's tests on the CPU
ask for the interpreter themselves.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# The tests run on the CPU unless JAX_PLATFORMS names other platforms
# (``JAX_PLATFORMS=cuda,cpu pytest -m gpu tests/`` runs the card-only
# tests on a GPU); set the live config too, in case something imported
# jax before this file.
import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def small_workload():
    """A small but tile-aligned workload: M=256, N=384, 50% sparse."""
    from tpusparse.testing import generators, reference

    a = generators.random_sparse_matrix(256, 384, density=0.5, seed=7)
    x = generators.random_sparse_vector(256, density=0.5, seed=7)
    y = reference.sgemv_cpu(x, a)
    return a, x, y


@pytest.fixture
def gpu_backend():
    """Skip unless a GPU backend is up (decided at run time, never at
    import: every xdist worker must collect the same tests)."""
    try:
        jax.devices("gpu")
    except RuntimeError:
        pytest.skip("needs the GPU; chip_smoke.py covers this on the card")


def assert_close(y, y_ref, atol=1e-3, name="kernel"):
    err = np.abs(np.asarray(y, dtype=np.float64) - np.asarray(y_ref, dtype=np.float64))
    bad = int((err > atol).sum())
    assert bad == 0, f"{name}: {bad} elements exceed atol={atol}, max|err|={err.max():.3e}"


# Persistent XLA compilation cache: the suite compiles ~100 shard_map
# programs; warm-cache reruns skip nearly all of it.
from tpusparse.utils.platform import enable_compile_cache  # noqa: E402

enable_compile_cache()
