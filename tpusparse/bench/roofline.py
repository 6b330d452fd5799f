"""Roofline accounting: speed-of-light nnz/s per format.

SURVEY.md §6: every product is memory-bound at these sizes, so the speed of
light is ``peak memory bandwidth / bytes-per-nnz of the format actually
used`` — counting *actual* bytes per format matters, because at density 0.5
a compressed format moves only ~2x fewer bytes than dense.
"""

from __future__ import annotations

from typing import Any

# Published peaks, keyed by ``jax.Device.device_kind``. A device that is not
# listed is an error, not a default. ``hbm_gbps``: device-memory bandwidth;
# ``link_gbps``: chip-to-chip bandwidth each way; ``cache_bytes``: the
# largest on-chip cache (what a timing's replica pool must exceed).
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(
        hbm_gbps=3350.0, link_gbps=450.0, cache_bytes=50 * 2**20,
        source="NVIDIA H100 SXM data sheet (data-sheet figures)"),
    "cpu": dict(
        hbm_gbps=50.0, link_gbps=50.0, cache_bytes=32 * 2**20,
        source="nominal host figures: they only exercise the arithmetic "
               "of CPU runs and are no device measurement"),
}


def device_peaks(device=None) -> dict[str, Any]:
    """The ``PEAKS`` row of ``device`` (default: the first JAX device)."""
    import jax

    d = device if device is not None else jax.devices()[0]
    kind = getattr(d, "device_kind", "")
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}; "
                       f"known: {sorted(PEAKS)}")
    return PEAKS[kind]


def detect_hbm_gbps() -> float:
    return device_peaks()["hbm_gbps"]


def format_bytes(fmt: Any) -> int:
    """Total device bytes a product must stream to read this format once."""
    import numpy as np

    if hasattr(fmt, "device_bytes"):
        return int(fmt.device_bytes())
    if hasattr(fmt, "shape"):  # bare dense array
        return int(np.prod(fmt.shape)) * fmt.dtype.itemsize
    import jax

    return sum(int(np.prod(l.shape)) * l.dtype.itemsize
               for l in jax.tree_util.tree_leaves(fmt))


def roofline_fraction(bytes_moved: int, seconds: float,
                      hbm_gbps: float | None = None) -> float:
    """Achieved fraction of the memory speed-of-light for this byte count."""
    if hbm_gbps is None:
        hbm_gbps = detect_hbm_gbps()
    sol_seconds = bytes_moved / (hbm_gbps * 1e9)
    return sol_seconds / seconds
