"""Device-mesh construction.

No reference counterpart — the reference is single-GPU (SURVEY.md §2.4); this
module is the BASELINE.json-mandated multi-chip layer. Axis names:

- ``"m"`` — contraction dim shards (each device holds a row-slab of A and the
  matching slice of X; partial Y's are reduced). The SpMV analog of the
  reference's intra-block split of M across 4 warps + smem reduction
  (asp.cu:13,30-40), lifted to chips + a cross-chip psum.
- ``"n"`` — output dim shards (each device owns a column-slab of A and its
  slice of Y; X must be visible to all, via replication or ring).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh

def make_mesh(shape: dict[str, int], devices=None) -> Mesh:
    """Mesh from {'m': a, 'n': b}; total must divide available devices."""
    devices = devices if devices is not None else jax.devices()
    names = tuple(shape.keys())
    dims = tuple(shape.values())
    total = int(np.prod(dims))
    if total > len(devices):
        raise ValueError(f"mesh {shape} needs {total} devices, have {len(devices)}")
    dev = np.asarray(devices[:total]).reshape(dims)
    return Mesh(dev, names)


def default_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over the output dim — the natural SpMV partition."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return make_mesh({"n": len(devices)}, devices)
