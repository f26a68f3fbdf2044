"""Host-side utilities: pair-file parsing, feature access, device choice.

A copy of the parts of ``abnet3_tpu/utils.py`` that the training and
evaluation slices use, with the same file formats and semantics, plus
:func:`resolve_device`, which every entry point of the port uses to pick
its device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["read_spkid_file", "read_dataset", "group_pairs",
           "Features_Accessor", "read_feats", "resolve_device",
           "pow2_bucket"]


def resolve_device(device=None, cuda: bool = True) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    card (``cuda=True``, the default) or the CPU (``cuda=False``).
    Raises when the card is asked for and none is present: the port never
    carries on quietly on the CPU."""
    if device is None:
        device = "cuda" if cuda else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "abnet3_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' (or cuda=False) to run on "
                "the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def read_spkid_file(spkid_file: str) -> Dict[str, str]:
    """Parse a ``fid spkid`` mapping file (reference utils.py:23-31)."""
    spk: Dict[str, str] = {}
    with open(spkid_file, "r") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            fid, spkid = line.split(" ")
            if fid in spk:
                raise ValueError(f"duplicate file id '{fid}' in {spkid_file}")
            spk[fid] = spkid
    return spk


def read_dataset(dataset_file: str) -> List[Tuple]:
    """Parse a 7-column pairs file: ``f1 s1 e1 f2 s2 e2 same|diff``
    (reference utils.py:156-173): ``strip().split(" ")`` per line, blank
    lines skipped."""
    pairs = []
    with open(dataset_file, "r") as fh:
        for line in fh:
            if not line.strip():
                continue
            tokens = line.strip().split(" ")
            if len(tokens) != 7:
                raise ValueError(
                    f"bad pairs line (want 7 columns): {line!r}")
            f1, s1, e1, f2, s2, e2, pair_type = tokens
            if pair_type not in ("same", "diff"):
                raise ValueError(f"unsupported pair type {pair_type}")
            pairs.append((f1, float(s1), float(e1),
                          f2, float(s2), float(e2), pair_type))
    return pairs


def group_pairs(pairs: Sequence[Tuple]) -> Dict[str, List[Tuple]]:
    """Group 7-tuples by pair type (reference utils.py:176-192)."""
    grouped: Dict[str, List[Tuple]] = {"same": [], "diff": []}
    for f1, s1, e1, f2, s2, e2, pair_type in pairs:
        if pair_type not in grouped:
            raise ValueError(f"unsupported pair type {pair_type}")
        grouped[pair_type].append((f1, s1, e1, f2, s2, e2))
    return grouped


class Features_Accessor:
    """Time- and frame-indexed access into {item: features} dicts
    (reference utils.py:118-145)."""

    def __init__(self, times: Dict, features: Dict):
        self.times = times
        first = features[next(iter(features))]
        if first.dtype != np.float32:
            features = {k: v.astype(np.float32) for k, v in features.items()}
        self.features = features

    @staticmethod
    def get_features_between(feature: np.ndarray, time: np.ndarray,
                             start: float, end: float) -> np.ndarray:
        t = np.where(np.logical_and(time >= start, time <= end))[0]
        return feature[t, :]

    def _key(self, f):
        # h5features 1.0 stored byte keys; accept both (ref utils.py:134-137)
        if f in self.times:
            return f
        fb = f.encode("utf-8") if isinstance(f, str) else f
        return fb if fb in self.times else f

    def get(self, f, on: float, off: float) -> np.ndarray:
        k = self._key(f)
        return self.get_features_between(self.features[k], self.times[k],
                                         on, off)

    def get_between_frames(self, f, frame_on: int,
                           frame_off: int) -> np.ndarray:
        k = self._key(f)
        return self.features[k][frame_on:frame_off]


def read_feats(features_file: str,
               align_features_file: Optional[str] = None):
    """Load a whole h5features corpus into a Features_Accessor
    (reference utils.py:211-226)."""
    from abnet3_torch.io.h5f import read_h5features
    data = read_h5features(features_file, "features")
    times = data.dict_labels()
    feats = data.dict_features()
    feat_dim = feats[next(iter(feats))].shape[1]
    accessor = Features_Accessor(times, feats)
    align_accessor = None
    if align_features_file is not None:
        adata = read_h5features(align_features_file, "features")
        align_accessor = Features_Accessor(adata.dict_labels(),
                                           adata.dict_features())
    return accessor, align_accessor, feat_dim


def pow2_bucket(n: int, minimum: int = 8) -> int:
    """Round up to a power-of-two bucket (``minimum`` times a power of
    two), so batch shapes repeat."""
    b = minimum
    while b < n:
        b *= 2
    return b
