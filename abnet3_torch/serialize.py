"""Pytree checkpoint IO (a copy of ``abnet3_tpu/serialize.py``, so that
``.pth`` files written by either package load in the other).

Networks are saved as flattened-key npz payloads (written through BytesIO so
the file keeps whatever extension the caller chose — the gridsearch YAML
contract names weight files ``<output_path>.pth``, reference
gridsearch.py:201, model.py:204-205; here the content is a safe npz archive,
not a torch pickle).
"""

from __future__ import annotations

import io
import json
import os
from typing import Any, Dict

import numpy as np

__all__ = ["save_pytree", "load_pytree"]

_SEP = "::"


_EMPTY_DICT = "__emptydict__"
_EMPTY_LIST = "__emptylist__"


def _check_key(k: str) -> str:
    """Reject dict keys the flat encoding cannot round-trip: keys
    containing the '::' separator, '#<i>' list markers, or the
    empty-container sentinels would silently restructure on load."""
    if isinstance(k, str) and (
            _SEP in k or (k.startswith("#") and k[1:].isdigit())
            or k in (_EMPTY_DICT, _EMPTY_LIST)):
        raise ValueError(
            f"dict key {k!r} collides with the checkpoint encoding "
            f"('{_SEP}' separator / '#i' list markers / sentinels) and "
            f"would not round-trip")
    return k


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        if not tree:
            # keep empty containers: SiameseMultitaskNetwork state is
            # {'trunk': {}, ...} with batch_norm off and must round-trip
            out[f"{prefix}{_EMPTY_DICT}"] = np.zeros(0, np.uint8)
            return out
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{_check_key(k)}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        if not tree:
            out[f"{prefix}{_EMPTY_LIST}"] = np.zeros(0, np.uint8)
            return out
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}{_SEP}"))
    else:
        out[prefix[:-len(_SEP)]] = np.asarray(tree)
    return out


def save_pytree(path: str, tree: Any, meta: Dict = None) -> None:
    flat = _flatten(tree)
    buf = io.BytesIO()
    arrays = {f"a{i}": v for i, v in enumerate(flat.values())}
    keymap = {f"a{i}": k for i, k in enumerate(flat.keys())}
    arrays["__keymap__"] = np.frombuffer(
        json.dumps(keymap).encode("utf-8"), dtype=np.uint8)
    if meta:
        arrays["__meta__"] = np.frombuffer(
            json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    np.savez(buf, **arrays)
    # atomic replace: a crash mid-write must never corrupt the previous
    # best-network / resume checkpoint (the reference overwrote in place)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(buf.getvalue())
    os.replace(tmp, path)


def load_pytree(path: str):
    """Returns (nested dict of np arrays, meta dict)."""
    with open(path, "rb") as fh:
        data = np.load(io.BytesIO(fh.read()), allow_pickle=False)
        keymap = json.loads(bytes(data["__keymap__"]).decode("utf-8"))
        meta = (json.loads(bytes(data["__meta__"]).decode("utf-8"))
                if "__meta__" in data else {})
        tree: Dict[str, Any] = {}
        for akey, flatkey in keymap.items():
            parts = flatkey.split(_SEP)
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(data[akey])
    return _relist(tree), meta


def _relist(node):
    """Convert {'#0': ..., '#1': ...} dicts back into lists and restore
    empty-container sentinels."""
    if not isinstance(node, dict):
        return node
    keys = list(node.keys())
    if keys == [_EMPTY_DICT]:
        return {}
    if keys == [_EMPTY_LIST]:
        return []
    if keys and all(k.startswith("#") and k[1:].isdigit() for k in keys):
        return [_relist(node[f"#{i}"]) for i in range(len(keys))]
    return {k: _relist(v) for k, v in node.items()}
