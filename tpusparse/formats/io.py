"""Format persistence: npz save/load for packed device formats.

SURVEY.md §5: the reference is stateless (no checkpointing); formats here get
save/load so converted benchmark matrices can be reused across runs — the
conversion (not the kernel) dominates end-to-end time for one-shot use.
"""

from __future__ import annotations

import ast

import numpy as np

from tpusparse.formats.awsp import AwspMatrix
from tpusparse.formats.binned import BinnedSellMatrix
from tpusparse.formats.bsr import BsrMatrix
from tpusparse.formats.dia import DiaMatrix
from tpusparse.formats.rsell import RsellMatrix
from tpusparse.formats.sell import SellMatrix
from tpusparse.formats.tcsr import TcsrMatrix
from tpusparse.kernels.asp_spmv import AspMatrix

_KINDS = {"sell": SellMatrix, "bsr": BsrMatrix,
          "awsp": AwspMatrix, "binned": BinnedSellMatrix, "asp": AspMatrix,
          "tcsr": TcsrMatrix, "rsell": RsellMatrix, "dia": DiaMatrix}


def encode(fmt) -> tuple[str, str, str, list[np.ndarray]]:
    """``(kind, aux_repr, dtypes_repr, leaf_arrays)`` for any packed
    format — the file-agnostic half of ``save``, reused by composite
    persisters (``amg.SmoothedAggregationAMG.save``). Non-numpy dtypes
    (bfloat16) are stored as raw uint16 with the dtype recorded — npz
    would otherwise silently degrade them to void ('|V2') arrays."""
    import jax

    kind = next((k for k, cls in _KINDS.items() if isinstance(fmt, cls)), None)
    if kind is None:
        raise TypeError(f"unsupported format {type(fmt).__name__}")
    leaves, _ = jax.tree_util.tree_flatten(fmt)
    arrays, dtypes = [], []
    for l in leaves:
        arr = np.asarray(l)
        dtypes.append(str(arr.dtype))
        if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
            arr = arr.view(np.uint16)
        arrays.append(arr)
    # each format may override the static metadata written to disk (e.g.
    # TCSR adds its nested dense tier's aux) via the _io_aux hook
    aux = fmt._io_aux() if hasattr(fmt, "_io_aux") else fmt.tree_flatten()[1]
    return kind, repr(tuple(aux)), repr(list(dtypes)), arrays


def save(path: str, fmt) -> None:
    """Persist any packed format. Leaves go as npz arrays; the static aux
    config (ints/tuples only) as a literal-parseable string."""
    kind, aux_r, dtypes_r, arrays = encode(fmt)
    np.savez_compressed(path, kind=kind, meta=np.asarray(aux_r),
                        leaf_dtypes=np.asarray(dtypes_r),
                        **{f"leaf{i}": a for i, a in enumerate(arrays)})


def decode(kind: str, aux_str: str, dtypes_str: str,
           arrays: list[np.ndarray], *, where: str = "<buffer>"):
    """Inverse of ``encode`` — shared by ``load`` and composite loaders."""
    aux = ast.literal_eval(aux_str)           # ints/tuples only
    if not isinstance(aux, (tuple, list)):
        # pre-r2 files stored a dict repr; unpacking its KEYS positionally
        # would silently build a corrupt object — mirror _expect and fail loud
        raise ValueError(
            f"{where}: meta is {type(aux).__name__}, expected the "
            f"tree_flatten aux tuple — incompatible file; re-pack from the "
            f"source matrix")
    dtypes = ast.literal_eval(dtypes_str) if dtypes_str is not None \
        else [None] * len(arrays)
    if len(dtypes) != len(arrays):
        raise ValueError(
            f"{where}: {len(arrays)} leaves but {len(dtypes)} recorded "
            f"dtypes — file layout drifted; re-pack from the source matrix")
    leaves = []
    for arr, dt in zip(arrays, dtypes):
        if dt == "bfloat16":
            import ml_dtypes

            arr = arr.view(ml_dtypes.bfloat16)
        leaves.append(arr)
    cls = _KINDS.get(kind)
    if cls is None:
        raise ValueError(f"unknown kind {kind!r} in {where}")
    # each class owns its leaf layout via the _io_rebuild hook (which
    # validates leaf counts and regroups nested/optional children); wrap
    # its errors with the file context so layout drift fails loudly
    try:
        return cls._io_rebuild(aux, leaves)
    except (ValueError, TypeError) as e:
        raise ValueError(
            f"{where}: {kind} file incompatible ({e}) — saved with an "
            f"incompatible tpusparse version; re-pack from the source "
            f"matrix") from e


def load(path: str):
    z = np.load(path, allow_pickle=False)
    kind = str(z["kind"])
    n_leaves = sum(1 for k in z.files
                   if k.startswith("leaf") and k != "leaf_dtypes")
    arrays = [z[f"leaf{i}"] for i in range(n_leaves)]
    return decode(kind, str(z["meta"]),
                  str(z["leaf_dtypes"]) if "leaf_dtypes" in z.files
                  else None, arrays, where=str(path))
