"""h5features-compatible reader/writer built directly on h5py.

The reference framework stores every feature corpus (filterbanks, stacked
frames, embeddings) in the bootphon *h5features* HDF5 container and uses both
its 1.0-style module API (``h5features.write(h5f, '/features/', items, times,
features)``, reference features.py:185-203) and its 1.1-style object API
(``Reader(path, 'features').read()`` returning a ``Data`` object with
``items()/labels()/features()/dict_labels()/dict_features()``, reference
utils.py:211-226 and embedder.py:73-100).

This module provides a thin, dependency-free implementation of the same
on-disk layout (one HDF5 group holding ``items``, ``labels``, ``features``
and an ``index`` of end-inclusive row offsets, ``version`` attribute
``'1.1'``) so that embeddings exported by this framework can be consumed by
external ABX evaluation tooling expecting h5features files, and vice versa.

This is a copy of ``abnet3_tpu/io/h5f.py`` with one change: ``h5py`` is
imported inside the functions that open a file, so ``import abnet3_torch``
works on a machine without it.

Writes are append-aware: calling :func:`write_h5features` repeatedly on the
same path extends the datasets, matching how the reference streams batches of
500 files into one container (reference features.py:178-203).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = [
    "H5FeaturesData",
    "write_h5features",
    "read_h5features",
    "read_h5features_item",
    "read_h5features_index",
    "iter_h5features",
]

class H5FeaturesData:
    """In-memory view of an h5features group.

    Mirrors the subset of the h5features 1.1 ``Data`` API the reference
    relies on (reference utils.py:213-215, embedder.py:76-78).
    """

    def __init__(self, items: Sequence[str], labels: List[np.ndarray],
                 features: List[np.ndarray], check: bool = True):
        if check:
            assert len(items) == len(labels) == len(features), (
                "items/labels/features must have the same length")
            for t, f in zip(labels, features):
                assert len(t) == len(f), (
                    "each item needs one timestamp per feature frame")
        self._items = list(items)
        self._labels = list(labels)
        self._features = list(features)

    def items(self) -> List[str]:
        return self._items

    def labels(self) -> List[np.ndarray]:
        return self._labels

    def features(self) -> List[np.ndarray]:
        return self._features

    def dict_labels(self) -> Dict[str, np.ndarray]:
        return dict(zip(self._items, self._labels))

    def dict_features(self) -> Dict[str, np.ndarray]:
        return dict(zip(self._items, self._features))

    def __len__(self) -> int:
        return len(self._items)


def _normalize_group(group: Optional[str]) -> str:
    if group is None:
        return "features"
    return group.strip("/") or "features"


def _resolve_group(fh: h5py.File, group: Optional[str]) -> h5py.Group:
    """Find the requested group, or the single group present in the file."""
    name = _normalize_group(group) if group is not None else None
    if name is not None and name in fh:
        return fh[name]
    keys = list(fh.keys())
    if len(keys) == 1:
        return fh[keys[0]]
    if name is not None:
        raise KeyError(f"group '{name}' not found in h5features file "
                       f"(available: {keys})")
    raise KeyError(f"ambiguous h5features file, groups: {keys}")


def _dataset_names(g: h5py.Group):
    """Map both 1.0 ('files'/'times'/'file_index') and 1.1
    ('items'/'labels'/'index') dataset names to a canonical triple."""
    items_name = "items" if "items" in g else "files"
    labels_name = "labels" if "labels" in g else "times"
    index_name = "index" if "index" in g else "file_index"
    return items_name, labels_name, index_name


def write_h5features(path: str, group: Optional[str], items: Sequence[str],
                     times: Sequence[np.ndarray],
                     features: Sequence[np.ndarray],
                     mode: str = "a") -> None:
    """Write (or append) items to an h5features file.

    Argument order follows the reference's 1.0-style calls
    ``h5features.write(h5f, '/features/', files, times, features)``
    (reference features.py:185-187,200-203).
    """
    assert len(items) == len(times) == len(features)
    if len(items) == 0:
        return
    feats = [np.atleast_2d(np.asarray(f)) for f in features]
    labs = [np.asarray(t, dtype=np.float64) for t in times]
    dim = feats[0].shape[1]
    for it, t, f in zip(items, labs, feats):
        assert f.ndim == 2 and f.shape[1] == dim, "inconsistent feature dims"
        # one label per feature row, per item: a mismatch would still
        # concatenate cleanly and write a container whose labels are
        # silently shifted across items on read
        assert len(t) == len(f), (
            f"item '{it}': {len(t)} labels for {len(f)} feature rows")
    feat_concat = np.concatenate(feats, axis=0)
    lab_concat = np.concatenate(labs, axis=0)
    counts = np.array([len(f) for f in feats], dtype=np.int64)

    import h5py
    gname = _normalize_group(group)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with h5py.File(path, mode) as fh:
        if gname in fh:
            g = fh[gname]
            items_name, labels_name, index_name = _dataset_names(g)
            # validate EVERYTHING before the first _append: the append
            # path is not atomic, so raising between appends would leave
            # items/labels longer than index/features and permanently
            # misalign every later read of the file
            if g["features"].shape[1] != dim:
                raise ValueError(
                    f"feature dim {dim} does not match the existing "
                    f"dataset's {g['features'].shape[1]} in {path}")
            if lab_concat.ndim != g[labels_name].ndim:
                raise ValueError(
                    f"label rank {lab_concat.ndim} does not match the "
                    f"existing dataset's {g[labels_name].ndim} in {path}")
            n_old = g[items_name].shape[0]
            existing = _existing_items(path, g, items_name, n_old)
            offset = int(g[index_name][-1]) + 1 if g[index_name].shape[0] else 0
            new_keys = []
            for it in items:
                key = it.encode("utf-8") if isinstance(
                    next(iter(existing), b""), bytes) else it
                if key in existing:
                    raise ValueError(f"item '{it}' already in {path}")
                new_keys.append(key)
            _append(g[items_name], np.array(items, dtype=object))
            _append(g[labels_name], lab_concat)
            _append(g["features"], feat_concat)
            # index stores the END-INCLUSIVE row of each item (h5features 1.1)
            _append(g[index_name], offset + np.cumsum(counts) - 1)
            existing.update(new_keys)
            _ITEMS_CACHE[_cache_key(path, g)] = (n_old + len(items),
                                                 existing)
        else:
            g = fh.create_group(gname)
            g.attrs["version"] = "1.1"
            g.create_dataset("items", data=np.array(items, dtype=object),
                             dtype=h5py.string_dtype(encoding="utf-8"),
                             maxshape=(None,))
            g.create_dataset("labels", data=lab_concat, maxshape=(None,))
            g.create_dataset(
                "features", data=feat_concat,
                maxshape=(None, dim), chunks=(min(8192, len(feat_concat)), dim))
            g.create_dataset("index", data=np.cumsum(counts) - 1,
                             maxshape=(None,))


def _append(dset: h5py.Dataset, data: np.ndarray) -> None:
    n_old = dset.shape[0]
    dset.resize(n_old + len(data), axis=0)
    dset[n_old:] = data


# item-name caches, invalidated by item count: batched exports append
# hundreds of times to one file, and re-decoding the full items dataset
# per call makes those passes O(N^2) in total item reads. Keyed by
# absolute path; a count mismatch (another writer, a fresh file)
# recomputes from disk.
_ITEMS_CACHE: Dict[str, tuple] = {}      # path -> (n_items, set of keys)
_POSITIONS_CACHE: Dict[str, tuple] = {}  # path -> (n_items, {name: pos})


def _cache_key(path: str, g: h5py.Group):
    return (os.path.abspath(path), g.name)


def _existing_items(path: str, g: h5py.Group, items_name: str,
                    n_old: int) -> set:
    key = _cache_key(path, g)
    cached = _ITEMS_CACHE.get(key)
    if cached is not None and cached[0] == n_old:
        return cached[1]
    existing = set(np.asarray(g[items_name]).tolist())
    _ITEMS_CACHE[key] = (n_old, existing)
    return existing


def _item_positions(path: str, g: h5py.Group, items_name: str) -> Dict:
    key = _cache_key(path, g)
    n = g[items_name].shape[0]
    cached = _POSITIONS_CACHE.get(key)
    if cached is not None and cached[0] == n:
        return cached[1]
    pos = {name: i
           for i, name in enumerate(_decode_items(np.asarray(g[items_name])))}
    _POSITIONS_CACHE[key] = (n, pos)
    return pos


def _decode_items(raw) -> List[str]:
    out = []
    for it in raw:
        out.append(it.decode("utf-8") if isinstance(it, bytes) else str(it))
    return out


def read_h5features_index(path: str, group: Optional[str] = None
                          ) -> List[str]:
    """Return the list of item names without loading any features."""
    import h5py
    with h5py.File(path, "r") as fh:
        g = _resolve_group(fh, group)
        items_name, _, _ = _dataset_names(g)
        return _decode_items(np.asarray(g[items_name]))


def read_h5features(path: str, group: Optional[str] = None
                    ) -> H5FeaturesData:
    """Load a whole h5features file (reference utils.py:211-215)."""
    import h5py
    with h5py.File(path, "r") as fh:
        g = _resolve_group(fh, group)
        items_name, labels_name, index_name = _dataset_names(g)
        items = _decode_items(np.asarray(g[items_name]))
        index = np.asarray(g[index_name], dtype=np.int64)
        ends = index + 1  # stored end-inclusive
        starts = np.concatenate(([0], ends[:-1]))
        feats_all = np.asarray(g["features"])
        labs_all = np.asarray(g[labels_name])
        features = [feats_all[s:e] for s, e in zip(starts, ends)]
        labels = [labs_all[s:e] for s, e in zip(starts, ends)]
    return H5FeaturesData(items, labels, features, check=False)


def iter_h5features(path: str, group: Optional[str] = None,
                    chunk_items: int = 64):
    """Stream ``(item, labels, features)`` triples without loading the
    whole corpus into RAM (read_h5features materializes everything, the
    reference's behavior — fine for test fixtures, a hard memory wall
    for multi-GB corpora). Disk reads batch ``chunk_items`` items per
    HDF5 access; memory stays O(chunk of items), independent of corpus
    size."""
    import h5py
    with h5py.File(path, "r") as fh:
        g = _resolve_group(fh, group)
        items_name, labels_name, index_name = _dataset_names(g)
        items = _decode_items(np.asarray(g[items_name]))
        index = np.asarray(g[index_name], dtype=np.int64)
        ends = index + 1
        starts = np.concatenate(([0], ends[:-1]))
        for c0 in range(0, len(items), chunk_items):
            c1 = min(c0 + chunk_items, len(items))
            lo, hi = int(starts[c0]), int(ends[c1 - 1])
            feats = np.asarray(g["features"][lo:hi])
            labs = np.asarray(g[labels_name][lo:hi])
            for i in range(c0, c1):
                s, e = int(starts[i]) - lo, int(ends[i]) - lo
                yield items[i], labs[s:e], feats[s:e]


def read_h5features_item(path: str, item: str, group: Optional[str] = None):
    """Read a single item: returns (times, features).

    Mirrors the reference's per-file reads
    ``h5features.read(fb_h5f, from_item=f)`` (reference features.py:310-316).
    """
    import h5py
    with h5py.File(path, "r") as fh:
        g = _resolve_group(fh, group)
        items_name, labels_name, index_name = _dataset_names(g)
        positions = _item_positions(path, g, items_name)
        if item not in positions:
            raise KeyError(f"item '{item}' not found in {path}")
        pos = positions[item]
        index = np.asarray(g[index_name], dtype=np.int64)
        end = int(index[pos]) + 1
        start = int(index[pos - 1]) + 1 if pos else 0
        return (np.asarray(g[labels_name][start:end]),
                np.asarray(g["features"][start:end]))
