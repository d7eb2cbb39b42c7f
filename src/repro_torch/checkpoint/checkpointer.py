"""npz + JSON checkpoints in the reference's format (port of
``repro.checkpoint.checkpointer``).

One ``.npz`` holds every leaf under its tree path (``0/torso/fc/w``,
``4/.inner/.stats/.count``); a JSON sidecar holds per-leaf kinds and
dtypes plus user metadata.  A ``QTensor`` leaf is stored as ``key#q``
and ``key#s`` with its ``bits`` in the sidecar.  Writes are atomic
(tmp file + ``os.replace``).  The keys, dtypes and sidecar are the
reference's, so a checkpoint written by either package restores in the
other.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.fxp import QTensor, is_qtensor
from repro_torch.tree import leaves_with_path, map_with_path, path_str

_NUMPY_RAW = {torch.bfloat16: ("bfloat16", np.uint16)}


def _to_numpy(t) -> Tuple[np.ndarray, str]:
    """(array to store, dtype name for the sidecar)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype in _NUMPY_RAW:
            name, raw = _NUMPY_RAW[t.dtype]
            return t.view(torch.int16).numpy().view(raw), name
        arr = t.numpy()
    else:
        arr = np.asarray(t)
    return arr, str(arr.dtype)


def _atomic_write(path: str, write) -> None:
    dirname = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=dirname, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save(path: str, tree: Any, metadata: Optional[Dict] = None) -> None:
    """Atomically write ``tree`` to ``path`` (.npz + .json sidecar)."""
    arrays: Dict[str, np.ndarray] = {}
    leaf_meta: Dict[str, Dict] = {}
    for p, leaf in leaves_with_path(tree, is_leaf=is_qtensor):
        key = path_str(p)
        if is_qtensor(leaf):
            arrays[key + "#q"] = _to_numpy(leaf.qvalue)[0]
            arrays[key + "#s"] = _to_numpy(leaf.scale)[0]
            leaf_meta[key] = {"kind": "qtensor", "bits": int(leaf.bits)}
        else:
            arr, dtype = _to_numpy(leaf)
            arrays[key] = arr
            leaf_meta[key] = {"kind": "array", "dtype": dtype}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _atomic_write(path, lambda f: np.savez(f, **arrays))
    side = {"leaves": leaf_meta, "metadata": metadata or {}}
    _atomic_write(path + ".json",
                  lambda f: f.write(json.dumps(side).encode()))


def read_metadata(path: str) -> Dict:
    """The sidecar metadata of the checkpoint at ``path``."""
    with open(path + ".json") as f:
        return json.load(f)["metadata"]


def _as_tensor(arr: np.ndarray, dtype_name: str,
               like: Optional[torch.Tensor], device) -> torch.Tensor:
    if dtype_name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    elif arr.dtype == np.uint32:
        # torch has no arithmetic on uint32; the reference stores PRNG
        # keys so, and their values fit int64
        t = torch.from_numpy(arr.astype(np.int64))
    else:
        t = torch.from_numpy(np.array(arr))     # a writable copy
    if like is not None:
        return t.to(device=like.device, dtype=like.dtype)
    return t if device is None else t.to(device)


def restore(path: str, like: Any, device=None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``like``: every leaf of the template
    is read back under its path (shapes come from the file), on the
    template leaf's device and dtype.  ``None`` subtrees are not read.
    Returns (tree, metadata)."""
    with np.load(path) as zf:
        data = {k: zf[k] for k in zf.files}
    with open(path + ".json") as f:
        side = json.load(f)

    def load(p, leaf):
        key = path_str(p)
        meta = side["leaves"].get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf '{key}'")
        if meta["kind"] == "qtensor":
            dev = leaf.device if isinstance(leaf, QTensor) else device
            return QTensor(_as_tensor(data[key + "#q"], "", None, dev),
                           _as_tensor(data[key + "#s"], "", None, dev),
                           meta["bits"])
        like_t = leaf if isinstance(leaf, torch.Tensor) else None
        return _as_tensor(data[key], meta["dtype"], like_t, device)

    return map_with_path(load, like, is_leaf=is_qtensor), side["metadata"]


def from_numpy_tree(tree: Any, device) -> Any:
    """A tree of numpy arrays, as the JAX package's params give them
    (``jax.tree.map(np.asarray, params)``), as the port's tree on
    ``device``.  A reference ``QTensor`` (any object with ``qvalue``,
    ``scale`` and ``bits``) or a ``(qvalue, scale, bits)`` triple with an
    int ``bits`` becomes a port ``QTensor``.  No transposes: the layouts
    are the same in both packages."""
    def is_q(x) -> bool:
        return (hasattr(x, "qvalue") and hasattr(x, "scale")
                and hasattr(x, "bits")) or (
            isinstance(x, tuple) and len(x) == 3
            and isinstance(x[2], int) and isinstance(x[0], np.ndarray))

    def convert(_p, leaf):
        if is_q(leaf):
            q, s, bits = ((leaf.qvalue, leaf.scale, leaf.bits)
                          if hasattr(leaf, "qvalue") else leaf)
            return QTensor(_as_tensor(np.asarray(q), "", None, device),
                           _as_tensor(np.asarray(s), "", None, device),
                           int(bits))
        return _as_tensor(np.asarray(leaf), "", None, device)

    return map_with_path(convert, tree, is_leaf=is_q)
