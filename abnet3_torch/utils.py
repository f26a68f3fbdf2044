"""Host-side utilities: text parsers, sampling distributions, feature
access, device choice.

A copy of the parts of ``abnet3_tpu/utils.py`` that the port uses, with
the same file formats and semantics (the sampling helpers draw from the
global ``np.random`` exactly as there), plus :func:`resolve_device`, which
every entry point of the port uses to pick its device, and
:func:`full_float32`.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["read_spkid_file", "read_spk_list", "read_dataset",
           "group_pairs", "read_vad_file", "print_token",
           "normalize_distribution", "cumulative_distribution",
           "sample_searchidx", "Features_Accessor", "read_feats",
           "resolve_device", "full_float32", "pow2_bucket"]


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


@contextlib.contextmanager
def full_float32():
    """Float32 matmuls and convolutions in full precision inside the
    block, the caller's TF32 settings restored on exit: TF32 keeps about
    three decimal digits, far coarser than the u16 tile codec's step of
    7.6e-6 and than the front end's parity with the JAX package."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


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


def read_spk_list(spk_file: str) -> List[str]:
    """One speaker id per line (reference utils.py:34-37)."""
    with open(spk_file, "r") as fh:
        return [line.strip() for line in fh]


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


def read_vad_file(path: str) -> Dict[str, List[List[float]]]:
    """CSV with header: ``file,start,end`` (reference utils.py:238-254)."""
    dict_vad: Dict[str, List[List[float]]] = defaultdict(list)
    with open(path, "r") as f:
        lines = [line.strip().split(",") for line in f]
    for name, s, e in lines[1:]:  # skip header
        dict_vad[name].append([float(s), float(e)])
    return dict_vad


def print_token(tok) -> str:
    """Format one token as ``fid start end`` with 2 decimals
    (reference utils.py:101-105)."""
    return "{0} {1:.2f} {2:.2f}".format(tok[0], tok[1], tok[2])


# sampling-distribution helpers (reference utils.py:63-98)

def normalize_distribution(p: Dict) -> Dict:
    total = float(sum(p.values()))
    if total > 0:
        for key in p:
            p[key] = p[key] / total
    return p


def cumulative_distribution(distribution: Dict) -> np.ndarray:
    values = np.asarray(list(distribution.values()), dtype=np.float64)
    cdf = np.cumsum(values)
    cdf /= cdf[-1]
    return cdf


def sample_searchidx(cdf: np.ndarray, num_samples: int) -> np.ndarray:
    """Inverse-CDF multinomial sampling (reference utils.py:92-98)."""
    uniform_samples = np.random.random_sample(int(num_samples))
    return cdf.searchsorted(uniform_samples, side="right")


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
