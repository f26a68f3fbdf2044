"""Host-side utilities: text parsers, sampling distributions, feature
access, device choice.

A copy of ``abnet3_tpu/utils.py``'s host helpers, with the same file
formats and semantics (the sampling helpers draw from the
global ``np.random`` exactly as there; :func:`read_dataset` and the
host DTW of :func:`get_dtw_alignment` go through the port's native
library, ``abnet3_torch.native``, as there), plus
:func:`resolve_device`, which every entry point of the port uses to pick
its device, and :func:`full_float32`.
"""

from __future__ import annotations

import contextlib
import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from abnet3_torch import native

__all__ = ["read_spkid_file", "read_spk_list", "read_dataset",
           "read_dataset_python", "group_pairs", "read_pairs",
           "read_vad_file", "Parse_Dataset", "print_token",
           "normalize_distribution", "cumulative_distribution",
           "sample_searchidx", "Features_Accessor", "read_feats",
           "resolve_device", "full_float32", "pow2_bucket",
           "cosine_distance", "dtw_numpy", "dtw_numpy_fast",
           "get_dtw_alignment", "progress", "to_ordinal", "get_var_name",
           "cast_features", "expand_dimension_list", "EmbeddingObserver",
           "SequentialPartialSave"]


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
    (reference utils.py:156-173) with the native C++ parser
    (``abnet3_torch.native.parse_pairs``), as the JAX package does: the
    tuples of :func:`read_dataset_python`, and on a malformed line
    ``ValueError("malformed pairs line N in PATH")``."""
    names, f1, s1, e1, f2, s2, e2, same = native.parse_pairs(dataset_file)
    return [(names[a], b, c, names[d], e, f, "same" if g > 0 else "diff")
            for a, b, c, d, e, f, g in zip(
                f1.tolist(), s1.tolist(), e1.tolist(), f2.tolist(),
                s2.tolist(), e2.tolist(), same.tolist())]


def read_dataset_python(dataset_file: str) -> List[Tuple]:
    """The Python pair-file parser: the reference's exact
    ``strip().split(" ")`` + 7-column contract (reference
    utils.py:156-173), blank lines skipped. The native parser mirrors
    these token semantics (``tests/test_torch_native.py`` holds the two
    together)."""
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


def read_pairs(pair_file: str) -> Dict[str, List[Tuple]]:
    return group_pairs(read_dataset(pair_file))


def read_vad_file(path: str) -> Dict[str, List[List[float]]]:
    """CSV with header: ``file,start,end`` (reference utils.py:238-254)."""
    dict_vad: Dict[str, List[List[float]]] = defaultdict(list)
    with open(path, "r") as f:
        lines = [line.strip().split(",") for line in f]
    for name, s, e in lines[1:]:  # skip header
        dict_vad[name].append([float(s), float(e)])
    return dict_vad


def Parse_Dataset(path: str) -> List[str]:
    """List ``.batch`` files in a folder (reference utils.py:108-115)."""
    return [os.path.join(path, f) for f in os.listdir(path)
            if f.endswith(".batch")]


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


# plain numpy versions of the host DTW: the host loader backend aligns
# through the native library (get_dtw_alignment); the tests hold these
# against both packages

def cosine_distance(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Angular cosine distance matrix arccos(cos_sim)/pi in [0, 1].

    Zero-norm rows are maximally distant from everything except other
    zero-norm rows (reference utils.py:40-60)."""
    x = np.asarray(x)
    y = np.asarray(y)
    x2 = np.sqrt(np.sum(x ** 2, axis=1))
    y2 = np.sqrt(np.sum(y ** 2, axis=1))
    ix = x2 == 0.0
    iy = y2 == 0.0
    denom = np.outer(np.where(ix, 1.0, x2), np.where(iy, 1.0, y2))
    sim = np.clip(np.dot(x, y.T) / denom, -1.0, 1.0)
    d = np.arccos(sim) / np.pi
    d[ix, :] = 1.0
    d[:, iy] = 1.0
    d[np.ix_(ix, iy)] = 0.0
    return np.asarray(d, dtype=np.float64)


def dtw_numpy(dist: np.ndarray) -> Tuple[float, np.ndarray, np.ndarray]:
    """Plain O(T1*T2) DTW with backtrace over a precomputed cost matrix:
    steps {(1,0),(0,1),(1,1)}, ties prefer the diagonal (the reference's
    Cython ``DTW(...)``, utils.py:147-153). Returns (total_cost, path1,
    path2) with paths from (0, 0) to the corner."""
    n1, n2 = dist.shape
    D = np.full((n1, n2), np.inf, dtype=np.float64)
    D[0, 0] = dist[0, 0]
    for i in range(1, n1):
        D[i, 0] = D[i - 1, 0] + dist[i, 0]
    for j in range(1, n2):
        D[0, j] = D[0, j - 1] + dist[0, j]
    for i in range(1, n1):
        for j in range(1, n2):
            D[i, j] = dist[i, j] + min(D[i - 1, j - 1], D[i - 1, j],
                                       D[i, j - 1])
    i, j = n1 - 1, n2 - 1
    p1, p2 = [i], [j]
    while i > 0 or j > 0:
        if i == 0:
            j -= 1
        elif j == 0:
            i -= 1
        else:
            diag, up, left = D[i - 1, j - 1], D[i - 1, j], D[i, j - 1]
            if diag <= up and diag <= left:
                i, j = i - 1, j - 1
            elif up <= left:
                i -= 1
            else:
                j -= 1
        p1.append(i)
        p2.append(j)
    return (float(D[n1 - 1, n2 - 1]),
            np.array(p1[::-1], dtype=np.int64),
            np.array(p2[::-1], dtype=np.int64))


def dtw_numpy_fast(dist: np.ndarray) -> Tuple[float, np.ndarray, np.ndarray]:
    """DTW over a cost matrix with steps {(1,0),(0,1),(1,1)}, each row of
    the DP one cumsum + one cumulative minimum (a (min,+) closed form),
    then the backtrace from the corner with ties going diagonal, then up,
    then left. Returns (total_cost, path1, path2), paths from (0, 0) to
    the corner."""
    n1, n2 = dist.shape
    D = np.empty((n1, n2), np.float64)
    D[0] = np.cumsum(dist[0])
    big = np.inf
    for i in range(1, n1):
        prev = D[i - 1]
        m = np.minimum(prev, np.concatenate(([big], prev[:-1])))
        c = dist[i]
        S = np.concatenate(([0.0], np.cumsum(c[1:])))
        b = m - np.concatenate(([-big], S[:-1]))
        cm = np.minimum.accumulate(b)
        x0 = prev[0] + c[0]
        D[i] = S + np.minimum(cm, x0)
    i, j = n1 - 1, n2 - 1
    p1, p2 = [i], [j]
    while i > 0 or j > 0:
        if i == 0:
            j -= 1
        elif j == 0:
            i -= 1
        else:
            diag, up, left = D[i - 1, j - 1], D[i - 1, j], D[i, j - 1]
            if diag <= up and diag <= left:
                i, j = i - 1, j - 1
            elif up <= left:
                i -= 1
            else:
                j -= 1
        p1.append(i)
        p2.append(j)
    return (float(D[n1 - 1, n2 - 1]),
            np.array(p1[::-1], dtype=np.int64),
            np.array(p2[::-1], dtype=np.int64))


def get_dtw_alignment(feat1: np.ndarray,
                      feat2: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host DTW alignment of two token feature matrices (reference
    utils.py:147-153), as the JAX package's host path: the native
    library's fused cosine distance (float64 products) and DTW
    (``abnet3_torch.native.dtw_align``). Returns the int64 index paths.
    Raises ``RuntimeError`` when the library cannot be built."""
    return native.dtw_align(feat1, feat2)


def progress(max_number: int, every: float = 0.1, title: str = ""):
    """Returns a callable printing progress every ``every`` fraction
    (reference utils.py:257-280)."""
    state = {"next": 0.0}

    def print_progress(current_progress):
        current = current_progress / max_number
        if current >= state["next"]:
            print("Progress: {:.1f}% of process {}".format(
                state["next"] * 100, title))
            state["next"] = (current // every) * every + every
    return print_progress


def to_ordinal(number: int) -> str:
    suffix = "th"
    if not 10 < number < 21:
        if number % 10 == 1:
            suffix = "st"
        elif number % 10 == 2:
            suffix = "nd"
        elif number % 10 == 3:
            suffix = "rd"
    return f"{number}{suffix}"


def get_var_name(**variable) -> str:
    """Name of the single keyword argument (reference utils.py:19-20):
    ``get_var_name(foo=foo) == 'foo'``."""
    return list(variable.keys())[0]


def cast_features(features: Dict[str, np.ndarray],
                  target_type=np.float32) -> Dict[str, np.ndarray]:
    """Cast every per-item feature matrix in place to ``target_type``
    (reference utils.py:228-237)."""
    for item in features:
        features[item] = features[item].astype(target_type)
    return features


def expand_dimension_list(dimensions_list) -> List[int]:
    """Expand [(dim, n), ...] run-length entries to a flat dim list
    (reference utils.py:354-365)."""
    final: List[int] = []
    for x in dimensions_list:
        if isinstance(x, int):
            final.append(x)
        elif isinstance(x, (tuple, list)):
            assert len(x) == 2
            final.extend([x[0]] * x[1])
        else:
            raise TypeError("Dimension list element must be int or tuple")
    return final


class EmbeddingObserver:
    """Records internal model responses (the learnt attention weights)
    during embedding and saves them as h5features beside the embeddings
    (reference utils.py:282-311)."""

    def __init__(self, status_getter, path: str):
        self.status_getter = status_getter
        self.path = path
        self.intern_responses: List[np.ndarray] = []

    def register_status(self):
        response = self.status_getter()
        if isinstance(response, torch.Tensor):
            response = response.detach().cpu().numpy()
        self.intern_responses.append(np.asarray(response))

    def record_arrays(self, arrays):
        """Bulk registration of per-file arrays the embedder's forward
        returned (the path :class:`~abnet3_torch.embedder
        .MultimodalEmbedder` uses)."""
        self.intern_responses = [np.asarray(a) for a in arrays]

    def save(self, items, times):
        from abnet3_torch.io.h5f import write_h5features
        if os.path.exists(self.path):
            os.remove(self.path)
        write_h5features(self.path, "features", items, times,
                         self.intern_responses)


class SequentialPartialSave:
    """The reference's call surface over
    :meth:`abnet3_torch.nn.Tower.forward` with ``save_partials=True``
    (reference utils.py:313-352): ``forward(x)``, then
    ``get_partial_result(i)``, index 0 the network's input and index i
    the input of the i-th Linear layer. The tower runs in eval mode, as
    the JAX package's adapter runs it (its mode is restored after)."""

    def __init__(self, tower):
        self.tower = tower
        self.partial_results: Dict[int, object] = {
            i: 0 for i in range(tower.spec.num_layers)}

    def get_partial_result(self, index: int):
        return self.partial_results[index]

    def forward(self, x):
        was_training = self.tower.training
        self.tower.eval()
        try:
            out, partials = self.tower(x, save_partials=True)
        finally:
            self.tower.train(was_training)
        for i, p in enumerate(partials):
            self.partial_results[i] = p
        return out

    __call__ = forward
