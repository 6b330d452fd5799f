"""Static column permutation of a product's output.

Formats that sort or re-place output columns (binned SELL, RSELL's sorted
and sharded packs) undo that placement once per call. ``permute_plan``
packs the permutation as (source group, in-group offset) planes:

- ``oidx[h, c]`` — in-group offset of the source of output lane (h, c);
- ``oh[h, g, c]`` — 1.0 iff output lane (h, c) sources from group g.

``apply_permutation`` recovers each output lane's source index from the
planes and applies it with one ``jnp.take``; lanes with no source (the
padding) come out zero.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from tpusparse.utils import round_up

_LANES = 128
_HB = 8          # output-group padding quantum of the plan planes


def permute_plan(perm_src: np.ndarray, src_size: int | None = None) -> dict:
    """Pack a static permutation: output lane p sources input lane
    ``perm_src[p]``. Returns oidx/oh padded to a multiple of 8 groups
    (padding maps to input lane 0 with a zero mask -> zero output).
    ``src_size``: source lane-space size when it differs from the output
    size (a selecting gather, not a square permutation)."""
    n = perm_src.size
    np_ = round_up(n, _LANES)
    src = np.zeros(np_, dtype=np.int64)
    src[:n] = perm_src
    nb_out = np_ // _LANES
    nb = round_up(src_size, _LANES) // _LANES if src_size else nb_out
    nbp = round_up(nb_out, _HB)
    g = src // _LANES                        # source group per output lane
    o = src % _LANES
    oidx = np.zeros((nbp, _LANES), np.int8)
    oidx[:nb_out] = o.reshape(nb_out, _LANES).astype(np.int8)
    oh = np.zeros((nbp, nb, _LANES), np.float32)
    hh = np.repeat(np.arange(nb_out), _LANES)
    cc = np.tile(np.arange(_LANES), nb_out)
    oh[hh, g, cc] = 1.0
    if n < np_:                              # padded output lanes -> 0
        dead = np.arange(n, np_)
        oh[dead // _LANES, :, dead % _LANES] = 0.0
    return dict(oidx=oidx, oh=oh, n=n, np_=np_, nb=nb)


@functools.partial(jax.jit, static_argnames=("n",))
def apply_permutation(y2d: jax.Array, plan_arrays: tuple, n: int):
    """y2d (B, np_) -> (B, n) permuted output."""
    oidx, oh = plan_arrays
    nbp = oh.shape[0]
    src = jnp.argmax(oh, axis=1) * _LANES + oidx.astype(jnp.int32)
    live = jnp.any(oh != 0, axis=1).reshape(nbp * _LANES)
    y = jnp.take(y2d, src.reshape(nbp * _LANES), axis=1, mode="clip")
    return jnp.where(live, y, 0)[:, :n]
