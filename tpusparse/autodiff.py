"""Differentiable sparse linear maps: ``y = x @ A`` with a custom VJP.

The reference is an inference benchmark (no gradients anywhere); a JAX-native
framework should compose with ``jax.grad`` so the sparse op can sit inside a
training loop. For a LINEAR map the rule is exact:

    y = x @ A        =>        dL/dx = g @ A.T        (g = dL/dy)

so the backward pass is just another SpMV/SpMM through a format packed from
``A.T``. ``linear_map`` builds both directions and registers the VJP; the
packed values are treated as constants (the frozen-sparse-weights regime —
masked pruning, MoE expert tables, serving-time adapters). Gradients w.r.t.
the *values* are intentionally not provided: they are dense in the mask
(dL/dA[m,j] = x[m] * g[j] on stored slots), which a training setup wants
fused into its optimizer layout, not materialized per step here.

Both directions ride the same packed-format products, so the backward pass
has the forward pass's byte ratio.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

import jax
import jax.numpy as jnp

from tpusparse.formats.csr import CsrMatrix


def linear_map(fmt: Any, fmt_t: Any = None, *,
               csr: CsrMatrix | None = None) -> Callable[[Any], jax.Array]:
    """``apply(x) -> x @ A`` (1-D spmv or 2-D row-batch spmm), differentiable
    w.r.t. ``x`` under jit/grad/vmap.

    ``fmt``   — any packed format with spmv/spmm (SELL, TCSR, RSELL, ...).
    ``fmt_t`` — same-API format packed from ``A.T`` for the backward pass.
       Omitted: packed automatically as ``type(fmt).from_csr(csr.transpose())``
       when ``csr`` (the CSR ``fmt`` was packed from) is given, else from
       ``fmt.to_dense().T`` (host round-trip — fine for moderate sizes,
       pass ``csr`` for matrices you never want dense).
    """
    if fmt_t is None:
        cls = type(fmt)
        if csr is not None:
            fmt_t = cls.from_csr(csr.transpose())
        else:
            mm, nn = fmt.shape
            if mm * nn * 4 > 2 << 30:
                raise ValueError(
                    f"packing the backward transpose from a dense "
                    f"round-trip would allocate {mm * nn * 4 / 1e9:.1f} GB; "
                    "pass csr= (no-densify, O(nnz)) or a pre-packed fmt_t=")
            fmt_t = cls.from_dense(fmt.to_dense().T)
    m, n = fmt.shape
    if tuple(fmt_t.shape) != (n, m):
        raise ValueError(
            f"fmt_t.shape {tuple(fmt_t.shape)} is not the transpose of "
            f"fmt.shape {(m, n)}")

    def _run(f: Any, v: jax.Array) -> jax.Array:
        return f.spmv(v) if v.ndim == 1 else f.spmm(v)

    @jax.custom_vjp
    def apply(x):
        return _run(fmt, x)

    def fwd(x):
        return _run(fmt, x), None

    def bwd(_res, g):
        return (_run(fmt_t, g),)

    apply.defvjp(fwd, bwd)
    return apply


# an output-column shard of A is a contraction shard of A.T and vice versa;
# "ring" is self-dual; "2d" (batch x output) is self-dual too — the backward
# just shards A.T's own output (m) groups over the same axis, no psum
_DUAL_PARTITION = {"n": "m", "m": "n", "ring": "ring", "2d": "2d"}


def linear_map_sharded(fmt: Any, fmt_t: Any, mesh: Any,
                       partition: str = "n") -> Callable[[Any], jax.Array]:
    """Differentiable ``x @ A`` over a device mesh (SELL formats).

    The backward pass is ``g @ A.T`` under the DUAL partition: an
    output-column shard of A is a contraction shard of A.T (and vice
    versa), so the transpose format reuses the same mesh axis — forward
    ``n`` pairs with backward ``m`` (whose partial sums psum across chips),
    and ``ring`` is self-dual. Values are frozen, as in ``linear_map``.
    """
    from tpusparse.parallel.sparse import sell_spmm_sharded

    m, n = fmt.shape
    if tuple(fmt_t.shape) != (n, m):
        raise ValueError(
            f"fmt_t.shape {tuple(fmt_t.shape)} is not the transpose of "
            f"fmt.shape {(m, n)}")
    if partition not in _DUAL_PARTITION:
        raise ValueError(f"unknown partition {partition!r}; supported: "
                         f"{sorted(_DUAL_PARTITION)}")
    dual = _DUAL_PARTITION[partition]

    @jax.custom_vjp
    def apply(x):
        return sell_spmm_sharded(fmt, x, mesh, partition)

    def fwd(x):
        return sell_spmm_sharded(fmt, x, mesh, partition), None

    def bwd(_res, g):
        return (sell_spmm_sharded(fmt_t, g, mesh, dual),)

    apply.defvjp(fwd, bwd)
    return apply


def _signed_idx(f, flat) -> tuple[np.ndarray, np.ndarray]:
    """``(signed, mask)``: int8 in-window indices with pad slots forced to
    -1 (a zero pad would alias in-window offset 0 and leak cotangent),
    plus the live-slot boolean mask."""
    mask = np.zeros(int(np.prod(f.vals.shape)), dtype=bool)
    mask[flat] = True
    mask = mask.reshape(f.vals.shape)
    return np.where(mask, np.asarray(f.idx), -1).astype(np.int8), mask


class _TwinPack:
    """One shared packing pass for the twin-layout trainable paths.

    Sorts the CSR first (legal CSR does not guarantee within-row column
    order, and every slot plane below assumes the packer's ranking), then
    packs both layouts, their live-slot maps, and the signed idx planes
    ONCE so the single-chip and sharded constructors cannot drift apart
    on layout decisions (and neither repeats the O(slots) passes).
    """

    def __init__(self, csr: CsrMatrix):
        from tpusparse.formats.sell import (SellMatrix, _sorted_rows,
                                            sell_slot_flat)

        self.csr = _sorted_rows(csr)
        self.csr_t = self.csr.transpose()            # O(nnz), computed once
        self.fmt = SellMatrix.from_csr(self.csr)
        self.fmt_t = SellMatrix.from_csr(self.csr_t)
        self.flat_f = sell_slot_flat(self.csr, self.fmt.w)
        self.flat_t = sell_slot_flat(self.csr_t, self.fmt_t.w)
        self.s_f, self.mask_f = _signed_idx(self.fmt, self.flat_f)
        self.s_t, self.mask_t = _signed_idx(self.fmt_t, self.flat_t)


def _tied_params(pack: "_TwinPack"):
    """``(params, masks, resync)`` shared by the single-chip and sharded
    constructors: the tied twin-layout values, their live-slot masks, and
    the exact re-tie map (transpose-entry i is forward-entry order[i] via
    csr.transpose's stable counting sort)."""
    # HOST-side leaves on purpose: an eager jnp.asarray here would upload
    # GBs DURING packing and leave them resident, so at GB scale the twin
    # pack alone could exhaust device memory before the train stage sizes
    # itself. Callers device_put what they need, once, where they need it.
    params = {"vals": np.asarray(pack.fmt.vals),
              "vals_t": np.asarray(pack.fmt_t.vals)}
    masks = {"vals": pack.mask_f, "vals_t": pack.mask_t}
    order = np.argsort(pack.csr.col_idx, kind="stable")
    t_vals_shape = pack.fmt_t.vals.shape
    t_map = np.full(int(np.prod(t_vals_shape)), -1, dtype=np.int64)
    t_map[pack.flat_t] = pack.flat_f[order]
    t_gather = np.clip(t_map, 0, None).astype(np.int32)
    t_live = t_map >= 0

    def resync(p):
        """Re-derive vals_t from vals exactly (kills accumulated ulp
        drift); one slot-permutation gather — use sparingly."""
        vt = jnp.where(jnp.asarray(t_live),
                       jnp.asarray(p["vals"]).ravel()[jnp.asarray(t_gather)],
                       0.0)
        return {"vals": p["vals"], "vals_t": vt.reshape(t_vals_shape)}

    return params, masks, resync


def trainable_linear(csr: CsrMatrix):
    """Sparse-weight TRAINING: ``apply(params, x) = x @ A`` differentiable
    in both the packed SELL values and ``x``, at format-bytes speed in both
    directions.

    Returns ``(apply, params, masks, resync)``:
      - ``params = {"vals", "vals_t"}``: the packed values in the forward
        layout AND the transpose layout. They are TIED copies of the same
        weights — the backward ``d/dx`` pass streams ``vals_t`` directly,
        so no per-step permutation is ever needed (a slot-permutation
        gather over every stored value costs far more than the forward).
        The VJP hands each copy the SAME mathematical gradient expressed in
        its own layout, so any ELEMENTWISE optimizer update (SGD, momentum,
        Adam, weight decay — anything computed per-slot from (param, grad)
        with identical hyperparameters) keeps the copies consistent up to
        floating-point rounding: XLA may fuse the same update as FMA in
        one layout and mul+sub in the other, so the copies can drift by
        ~1 ulp per step (a slow random walk, ~sqrt(steps) ulps — harmless
        against gradient noise). Call the returned ``resync`` every
        O(10k) steps (or at checkpoints) to re-derive ``vals_t`` from
        ``vals`` exactly; it costs one slot-permutation gather, which is
        why it is not done per step. Non-elementwise
        updates (e.g. per-leaf norm clipping) would desynchronize the
        copies faster — clip on the combined pytree, which applies the
        same scale to both.
      - ``masks``: matching bool pytree, True on real slots. Cotangents are
        masked (pad slots get exactly zero gradient); updates that move
        parameters WITHOUT gradients must respect the mask themselves —
        a nonzero pad slot would contribute to the product (its in-window
        index aliases offset 0).

    Cotangents (all format-bytes-speed):
      - d/dx        — one SpMV/SpMM through the transpose layout;
      - d/dvals     — ``kernels/sell_grad.py``: the closed form
        x[m(slot)] * g[col(slot)] via the forward product's own in-window
        gather;
      - d/dvals_t   — the same form on the transpose layout with the
        roles of x and g swapped.

    The reference has no training story at all; this is the JAX-native
    extension that turns the format measurements into a usable sparse
    layer (frozen mask, live values — the standard pruned-training
    regime). Cost: 2x value memory for the twin layout.
    """
    return _trainable_from_pack(_TwinPack(csr))


def _trainable_from_pack(pack: "_TwinPack"):
    from tpusparse.formats.sell import SellMatrix
    from tpusparse.kernels.sell_grad import sell_dvals_padded

    fmt, fmt_t = pack.fmt, pack.fmt_t
    # host-side numpy (see _tied_params): the default small-scale path
    # inlines these as HLO constants exactly as before; GB users pass
    # device_put(apply.statics) via the statics kwarg
    default_statics = {
        "idx": np.asarray(fmt.idx),        # fwd in-window offsets
        "idx_t": np.asarray(fmt_t.idx),    # transpose-layout offsets
        "s_f": np.asarray(pack.s_f),       # slot-permutation planes
        "s_t": np.asarray(pack.s_t),       # (value-gradient kernels)
    }
    params, masks, resync = _tied_params(pack)
    # keep only static metadata in the closures — fmt/fmt_t hold host-side
    # numpy copies of vals+idx (~2x format bytes) that params/idx already
    # duplicate on device
    shape, padded, w_f, nnz = fmt.shape, fmt.padded, fmt.w, fmt.nnz
    shape_t, padded_t, w_t = fmt_t.shape, fmt_t.padded, fmt_t.w
    mp, np_pad = padded
    del fmt, fmt_t, pack

    def _run(f, v):
        return f.spmv(v) if v.ndim == 1 else f.spmm(v)

    def _pad2(v, width):
        v2 = jnp.atleast_2d(jnp.asarray(v))
        return jnp.pad(v2, ((0, 0), (0, width - v2.shape[1])))

    # The structure planes ride as ARGUMENTS of the custom_vjp (integer
    # primals; their cotangents are the sanctioned float0 zeros). Why:
    # closed-over arrays lower as INLINE stablehlo constants — tens of MB
    # of HLO at 4096^2 d=0.02, growing with nnz — so at GB scale the
    # program itself becomes the problem. Passing ``apply.statics``
    # (device_put once) via the ``statics=`` kwarg keeps the program size
    # flat; omitting it keeps the small-scale convenience path.
    def _primal(statics, params, x):
        return _run(SellMatrix(statics["idx"], params["vals"], shape,
                               padded, w_f, nnz), x)

    cv = jax.custom_vjp(_primal)

    def fwd(statics, params, x):
        return _primal(statics, params, x), (statics, params["vals_t"], x)

    def bwd(res, g):
        statics, vals_t, x = res
        dx = _run(SellMatrix(statics["idx_t"], vals_t, shape_t, padded_t,
                             w_t, nnz), g)
        x2, g2 = _pad2(x, mp), _pad2(g, np_pad)
        dvals = sell_dvals_padded(statics["s_f"], x2, g2)
        dvals_t = sell_dvals_padded(statics["s_t"], g2, x2)
        ct_statics = jax.tree_util.tree_map(
            lambda a: np.zeros(a.shape, jax.dtypes.float0), statics)
        return ct_statics, {"vals": dvals, "vals_t": dvals_t}, dx

    cv.defvjp(fwd, bwd)

    def apply(params, x, statics=None):
        return cv(default_statics if statics is None else statics,
                  params, x)

    apply.statics = default_statics
    return apply, params, masks, resync


def trainable_linear_sharded(csr: CsrMatrix, mesh: Any):
    """Multi-chip sparse-weight training: ``trainable_linear`` with every
    pass partitioned over ``mesh`` (axis "n").

    Sharding plan (one mesh axis, D shards):
      - forward ``x @ A``: output-column partition ("n") — vals shard on
        their column-group axis, X replicated, no steady-state comm;
      - ``d/dx = g @ A.T``: the dual contraction partition ("m") — vals_t
        shard on their n-window axis, partial sums psum across chips;
      - both value gradients: comm-free shard_map — each chip computes the
        dvals/dvals_t blocks it owns from its local g slice (g is sharded
        by output groups for dvals and by n-windows for dvals_t, X/g's
        other operand replicated).
    The twin layouts therefore shard on DIFFERENT axes of their arrays
    (vals: axis 0, vals_t: axis 1) but over the same mesh axis, so one
    elementwise optimizer update keeps per-chip work balanced. Same tied-
    copy semantics (ulp-drift + ``resync``) as ``trainable_linear``.
    """
    from jax.sharding import PartitionSpec as P

    from tpusparse.formats.sell import SellMatrix
    from tpusparse.kernels.sell_grad import sell_dvals_padded
    from jax import shard_map as _shard_map
    from tpusparse.parallel.sparse import sell_spmm_sharded

    # ONE packing pass shared with the single-chip constructor — the pack
    # sorts the CSR first, so the slot planes below line up with the params
    # (an independently rebuilt plane from the caller's UNSORTED csr gave
    # silently wrong vals gradients). _tied_params gives the shared
    # params/masks/resync directly — building (and discarding) the whole
    # single-chip apply here would upload four idx planes for nothing.
    pack = _TwinPack(csr)
    params, masks, resync = _tied_params(pack)
    fmt, fmt_t = pack.fmt, pack.fmt_t
    d = mesh.shape["n"]

    def signed(s, axis):
        # group-pad the precomputed signed plane for shard divisibility
        # with -1 so padded groups emit zero cotangent
        pad = -s.shape[axis] % d
        if pad:
            widths = [(0, 0)] * s.ndim
            widths[axis] = (0, pad)
            s = np.pad(s, widths, constant_values=-1)
        return jnp.asarray(s)

    idx_s = signed(pack.s_f, 0)        # shard column groups (axis 0)
    idx_ts = signed(pack.s_t, 1)       # shard n-windows (axis 1)
    w_f, w_t = fmt.w, fmt_t.w
    nb_f, nt_t = fmt.vals.shape[0], fmt_t.vals.shape[1]
    mp, np_pad = fmt.padded

    def _sharded_dvals(idx_arr, x_side, g_side, axis, out_real):
        """shard_map the value-gradient form over the idx shard axis.
        axis 0 (column groups sharded): the output-side vector (g_side)
        splits with the groups, the window-side vector replicates; axis 1
        (windows sharded): vice versa."""
        if axis == 0:
            tgt = idx_arr.shape[0] * 128
            g_side = jnp.pad(g_side, ((0, 0), (0, tgt - g_side.shape[1])))
            specs = (P("n"), P(), P(None, "n"))
            out_spec = P("n")
        else:
            tgt = idx_arr.shape[1] * 128
            x_side = jnp.pad(x_side, ((0, 0), (0, tgt - x_side.shape[1])))
            specs = (P(None, "n"), P(None, "n"), P())
            out_spec = P(None, "n")

        out = _shard_map(sell_dvals_padded, mesh=mesh, check_vma=False,
                         in_specs=specs, out_specs=out_spec)(
            idx_arr, x_side, g_side)
        sl = [slice(None)] * out.ndim
        sl[axis] = slice(0, out_real)
        return out[tuple(sl)]

    def _pad2(v, width):
        v2 = jnp.atleast_2d(jnp.asarray(v))
        return jnp.pad(v2, ((0, 0), (0, width - v2.shape[1])))

    # hoist the idx uploads and keep only static metadata in the closures
    # (as in _trainable_from_pack: fmt/fmt_t hold host copies of vals+idx
    # that params/idx_dev already duplicate on device)
    idx_dev, idx_t_dev = jnp.asarray(fmt.idx), jnp.asarray(fmt_t.idx)
    shape_f, padded_f, nnz_f = fmt.shape, fmt.padded, fmt.nnz
    shape_t, padded_t, nnz_t = fmt_t.shape, fmt_t.padded, fmt_t.nnz
    del pack, fmt, fmt_t

    def _fmt(vals):
        return SellMatrix(idx_dev, vals, shape_f, padded_f, w_f, nnz_f)

    def _fmt_t(vals_t):
        return SellMatrix(idx_t_dev, vals_t, shape_t, padded_t, w_t, nnz_t)

    def _primal(p, x):
        return sell_spmm_sharded(_fmt(p["vals"]), x, mesh, "n")

    apply = jax.custom_vjp(_primal)

    def fwd(p, x):
        return _primal(p, x), (p["vals_t"], x)

    def bwd(res, g):
        vals_t, x = res
        dx = sell_spmm_sharded(_fmt_t(vals_t), g, mesh, "m")
        x2, g2 = _pad2(x, mp), _pad2(g, np_pad)
        # dvals: g sharded by column group (axis 0 of idx_s); dvals_t: g is
        # the contraction side, sharded by n-window (axis 1 of idx_ts)
        dvals = _sharded_dvals(idx_s, x2, g2, 0, nb_f)
        dvals_t = _sharded_dvals(idx_ts, g2, x2, 1, nt_t)
        return {"vals": dvals, "vals_t": dvals_t}, dx

    apply.defvjp(fwd, bwd)
    return apply, params, masks, resync
