"""Every format's XLA product against the float64 oracle, over storage dtype,
batch size and aligned / unaligned shapes, plus the platform pieces around
them: the published-peaks table, the compile cache and the chip smoke
script's refusal to run without a GPU."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp

from tests.conftest import assert_close
from tpusparse.testing import generators, reference

_ROOT = Path(__file__).resolve().parent.parent

# tolerances: fp32 storage is held to the reference's 1e-3 contract
# (tester.cpp:75); bf16 values round each stored value to 8 bits of
# mantissa and int8 values to 1/254 of the column max, so their products
# carry the quantization error, not a summation error
_ATOL = {"fp32": 1e-3, "bf16": 5e-2, "int8": 1e-1}

_CASES = [("sell", "fp32"), ("sell", "bf16"), ("sell", "int8"),
          ("awsp", "fp32"), ("awsp", "bf16"), ("asp", "fp32"),
          ("bsr", "fp32"), ("tcsr", "fp32"), ("rsell", "fp32"),
          ("binned", "fp32"), ("dia", "fp32")]

_SHAPES = {"aligned": (256, 384), "unaligned": (200, 330)}


def _pack(kind, dtype, a):
    store = {"fp32": None, "bf16": jnp.bfloat16, "int8": "int8"}[dtype]
    if kind == "sell":
        from tpusparse.formats.sell import SellMatrix

        return SellMatrix.from_dense(a, dtype=store)
    if kind == "awsp":
        from tpusparse.formats.awsp import AwspMatrix

        return AwspMatrix.from_dense(a, dtype=store)
    if kind == "asp":
        from tpusparse.kernels.asp_spmv import AspMatrix

        return AspMatrix.from_dense(a, block_n=128)
    if kind == "bsr":
        from tpusparse.formats.bsr import BsrMatrix

        return BsrMatrix.from_dense(a, block_m=128)
    if kind == "tcsr":
        from tpusparse.formats.tcsr import TcsrMatrix

        return TcsrMatrix.from_dense(a)
    if kind == "rsell":
        from tpusparse.formats.rsell import RsellMatrix

        return RsellMatrix.from_dense(a)
    if kind == "binned":
        from tpusparse.formats.binned import BinnedSellMatrix

        return BinnedSellMatrix.from_dense(a)
    from tpusparse.formats.dia import DiaMatrix

    return DiaMatrix.from_dense(a)


def _matrix(kind, m, n):
    if kind == "dia":
        return generators.random_sparse_matrix(m, n, density=0.05, seed=3,
                                               distribution="banded",
                                               bandwidth=6)
    if kind in ("bsr", "tcsr"):
        return generators.random_sparse_matrix(m, n, density=0.4, seed=3,
                                               distribution="blocks",
                                               block=64)
    return generators.random_sparse_matrix(m, n, density=0.2, seed=3,
                                           distribution="powerlaw")


@pytest.mark.parametrize("shape", sorted(_SHAPES))
@pytest.mark.parametrize("batch", [1, 3, 8, 32])   # 32: the train step's
@pytest.mark.parametrize("kind,dtype", _CASES)
def test_xla_form_matches_oracle(kind, dtype, batch, shape):
    m, n = _SHAPES[shape]
    a = _matrix(kind, m, n)
    f = _pack(kind, dtype, a)
    xb = generators.random_sparse_batch(batch, m, density=0.5, seed=batch)
    y = f.spmv(xb[0]) if batch == 1 else f.spmm(xb)
    y_ref = reference.sgemm_cpu(xb, a)
    y = np.asarray(y).reshape(batch, -1)
    assert y.shape == (batch, n)
    assert_close(y, y_ref, atol=_ATOL[dtype], name=f"{kind}[{dtype}]")


def test_sell_form_output_is_one_row_per_batch_row():
    """The product returns (B, N_padded): one row per activation, no
    replicated sum rows."""
    from tpusparse.formats.sell import SellMatrix
    from tpusparse.kernels.sell_spmv import sell_spmm_padded

    a = generators.random_sparse_matrix(256, 200, density=0.3, seed=5)
    s = SellMatrix.from_dense(a)
    xb = generators.random_sparse_batch(3, 256, density=0.5, seed=5)
    out = sell_spmm_padded(s.idx, s.vals, jnp.asarray(xb))
    assert out.shape == (3, 256)
    assert_close(np.asarray(out)[:, :200], reference.sgemm_cpu(xb, a),
                 name="sell raw")


def test_roofline_raises_on_unknown_device():
    from tpusparse.bench.roofline import device_peaks

    class _Dev:
        device_kind = "Imaginary Accelerator 9000"

    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks(_Dev())


def test_roofline_knows_cpu_and_h100():
    from tpusparse.bench.roofline import PEAKS, device_peaks, \
        roofline_fraction

    assert device_peaks()["hbm_gbps"] == PEAKS["cpu"]["hbm_gbps"]
    h100 = PEAKS["NVIDIA H100 80GB HBM3"]
    assert h100["hbm_gbps"] == 3350.0 and h100["link_gbps"] == 450.0
    # one second per 3.35 TB is the H100's memory roofline exactly
    assert roofline_fraction(3_350_000_000_000, 1.0,
                             hbm_gbps=h100["hbm_gbps"]) == pytest.approx(1.0)


def _cache_dir_in_subprocess(env_extra, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(env_extra)
    code = ("from tpusparse.utils import enable_compile_cache;"
            "print(enable_compile_cache())")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-500:]
    return r.stdout.strip().splitlines()[-1]


def test_compile_cache_honours_env(tmp_path):
    want = str(tmp_path / "cache-from-env")
    got = _cache_dir_in_subprocess(
        {"JAX_COMPILATION_CACHE_DIR": want,
         "PYTHONPATH": str(_ROOT)}, tmp_path)
    assert got == want


def test_compile_cache_defaults_inside_checkout(tmp_path):
    got = _cache_dir_in_subprocess({"PYTHONPATH": str(_ROOT)}, tmp_path)
    assert Path(got) == _ROOT / ".jax_cache"
    ignored = (_ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def _smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_refuses_cpu():
    r = _smoke(_ROOT, _ROOT / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_refuses_without_the_repo(tmp_path):
    script = tmp_path / "chip_smoke.py"
    script.write_text((_ROOT / "chip_smoke.py").read_text())
    r = _smoke(tmp_path, script)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.gpu
@pytest.mark.parametrize("kind,dtype", _CASES)
def test_xla_form_on_gpu(gpu_backend, kind, dtype):
    """The compiled GPU product of every format at a tile-aligned size."""
    a = _matrix(kind, 1024, 1024)
    f = _pack(kind, dtype, a)
    xb = generators.random_sparse_batch(8, 1024, density=0.5, seed=11)
    assert_close(f.spmm(xb), reference.sgemm_cpu(xb, a),
                 atol=_ATOL[dtype], name=f"gpu {kind}[{dtype}]")
