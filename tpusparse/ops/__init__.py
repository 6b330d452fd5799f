"""Public compute surface: ``spmv`` / ``spmm`` dispatch over formats.

The reference exposed one uniform launcher ABI per kernel family —
``X_gemv_gpu(M, N, A, X, Y)`` (kernel.hpp:8-17). Here the uniform surface is
``spmv(a, x)`` where ``a`` is a dense array or any ``tpusparse.formats``
object; each format carries its kernel (format.spmv / format.spmm), mirroring
how each reference launcher constructed its own converter (e.g. awsp.cu:323).
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp
import numpy as np

from tpusparse.kernels.dense import dense_xla


def _is_dense(a: Any) -> bool:
    return isinstance(a, (np.ndarray, jnp.ndarray))


def _check_compute_format(a: Any) -> None:
    from tpusparse.formats.csr import CsrMatrix

    if isinstance(a, CsrMatrix):
        raise TypeError(
            "CsrMatrix is an interchange format (raw row-pointer gathers "
            "are shape-dynamic, which XLA does not compile); pack it first, "
            "e.g. auto_format(csr) or SellMatrix.from_csr(csr) — every "
            "compute format packs from CSR without densifying")


def spmv(a: Any, x: Any) -> Any:
    """y = x @ a for a single vector x of shape (m,)."""
    x = jnp.asarray(x)
    if _is_dense(a):
        return dense_xla(jnp.asarray(a), x)
    _check_compute_format(a)
    return a.spmv(x)


def spmm(a: Any, x: Any) -> Any:
    """y = x @ a for batched x of shape (b, m) — the SpMM extension."""
    x = jnp.asarray(x)
    if _is_dense(a):
        return dense_xla(jnp.asarray(a), x)
    _check_compute_format(a)
    return a.spmm(x)
