"""Train and dev word pairs drawn from a corpus, vectorised.

A copy of the distribution of the port's ``SamplerClusterSiamese``
(``abnet3_torch/sampler.py``) with the flagship's arguments, written for
whole arrays instead of Python loops: the classes split into train and
dev by ``ratio_train_dev`` (classes above ``max_size_cluster`` split
their tokens), then in each split the four configurations (same or
different type x same or different speaker) in the sampler's shares,
each drawn from P(type) P(speaker | type) with the ``log`` transform,
and the tokens uniformly within their (type, speaker) group. The one
departure: for a different-type different-speaker key the sampler keeps
whichever of the two type orders it met last; here both orders carry
their product weight, which is the distribution that quirk approximates.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from h100_bench.core.corpus import Corpus, host_rng

_TRANSFORMS = {"log": np.log1p, "f": np.sqrt, "f2": lambda x: x,
               "fcube": np.cbrt, "1": lambda x: (x > 0).astype(float)}


def split_tokens(corpus: Corpus, p: dict, rng) -> Tuple[np.ndarray,
                                                       np.ndarray]:
    """(train token ids, dev token ids)."""
    cls = corpus.tok_class
    C = int(cls.max()) + 1
    sizes = np.bincount(cls, minlength=C)
    r = p["ratio_train_dev"]
    in_train = np.zeros(C, bool)
    in_train[rng.choice(C, int(r * C), replace=False)] = True
    train = in_train[cls].copy()
    big = (p["max_size_cluster"] > 1) & (sizes > p["max_size_cluster"])
    on_big = big[cls]
    # a big class sends its first int(r * size) tokens of a random order
    # to train
    key = rng.random(len(cls))
    order = np.lexsort((key, cls))
    rank = np.empty(len(cls), np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    rank[order] = np.arange(len(cls)) - starts[cls[order]]
    train[on_big] = rank[on_big] < (r * sizes[cls[on_big]]).astype(int)
    return np.flatnonzero(train), np.flatnonzero(~train)


def _draw(weights: np.ndarray, n: int, rng) -> np.ndarray:
    cdf = np.cumsum(weights, dtype=np.float64)
    return np.minimum(np.searchsorted(cdf, rng.random(n) * cdf[-1],
                                      side="right"), len(cdf) - 1)


class _Groups:
    """Tokens of one split by (speaker, type): counts and uniform draws."""

    def __init__(self, toks: np.ndarray, corpus: Corpus, S: int, C: int):
        self.S, self.C = S, C
        g = corpus.tok_speaker[toks] * C + corpus.tok_class[toks]
        order = np.argsort(g, kind="stable")
        self.sorted = toks[order]
        self.count = np.bincount(g, minlength=S * C).reshape(S, C)
        self.start = np.concatenate([[0], np.cumsum(self.count.ravel())
                                     [:-1]]).reshape(S, C)

    def draw(self, s, k, rng, exclude=None):
        cnt = self.count[s, k] - (0 if exclude is None else 1)
        i = np.floor(rng.random(len(s)) * cnt).astype(np.int64)
        if exclude is not None:
            i += i >= exclude
        return i, self.sorted[self.start[s, k] + i]


def sample_split(toks: np.ndarray, n: int, corpus: Corpus, p: dict, rng
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(tok1, tok2, same_type) of ``n`` pairs of one split."""
    S = int(corpus.tok_speaker.max()) + 1
    C = int(corpus.tok_class.max()) + 1
    grp = _Groups(toks, corpus, S, C)
    c = grp.count.astype(np.float64)
    f_spk = _TRANSFORMS[p["spk_sampling_mode"]](c) * (c > 0)
    F = _TRANSFORMS[p["type_sampling_mode"]](c.sum(0))      # (C,)
    n_same_spk = int(n * (1 - p["ratio_same_diff_spk"]))
    n_diff_spk = n - n_same_spk
    rt = p["ratio_same_diff_type"]
    counts = {"SS": int(n_same_spk * (1 - rt)), "DS": int(n_same_spk * rt),
              "SD": int(n_diff_spk * (1 - rt)), "DD": int(n_diff_spk * rt)}
    out1, out2, same = [], [], []

    # same type, same speaker: (s, k) with two tokens or more
    w = (f_spk * (c >= 2) * F[None, :]).ravel()
    sk = _draw(w, counts["SS"], rng)
    s, k = sk // C, sk % C
    i, t1 = grp.draw(s, k, rng)
    _, t2 = grp.draw(s, k, rng, exclude=i)
    out1.append(t1), out2.append(t2), same.append(np.ones(len(s), bool))

    # same type, different speakers: k, then s1 != s2 within it
    tot = f_spk.sum(0)
    k = _draw(F * (tot ** 2 - (f_spk ** 2).sum(0)), counts["SD"], rng)
    s1, s2 = _pair_draw(lambda kk, m: _draw_cols(f_spk, kk, m, rng), k)
    out1.append(grp.draw(s1, k, rng)[1]), out2.append(grp.draw(s2, k, rng)[1])
    same.append(np.ones(len(k), bool))

    # different types, same speaker: s, then k1 != k2 within it
    fF = f_spk * F[None, :]
    s = _draw(fF.sum(1) ** 2 - (fF ** 2).sum(1), counts["DS"], rng)
    k1, k2 = _pair_draw(lambda ss, m: _draw_rows(fF, ss, m, rng), s)
    out1.append(grp.draw(s, k1, rng)[1]), out2.append(grp.draw(s, k2, rng)[1])
    same.append(np.zeros(len(s), bool))

    # different types, different speakers: two (s, k) entries
    m = counts["DD"]
    a, b = np.empty(m, np.int64), np.empty(m, np.int64)
    todo = np.arange(m)
    flat = fF.ravel()
    while len(todo):
        a[todo], b[todo] = _draw(flat, len(todo), rng), \
            _draw(flat, len(todo), rng)
        todo = todo[(a[todo] // C == b[todo] // C)
                    | (a[todo] % C == b[todo] % C)]
    out1.append(grp.draw(a // C, a % C, rng)[1])
    out2.append(grp.draw(b // C, b % C, rng)[1])
    same.append(np.zeros(m, bool))

    t1, t2, y = (np.concatenate(x) for x in (out1, out2, same))
    perm = rng.permutation(len(t1))
    return t1[perm], t2[perm], y[perm]


def _draw_cols(w, cols, m, rng):
    """One row index per column ``cols`` of ``w``, drawn by its weights."""
    cdf = np.cumsum(w[:, cols], axis=0)
    u = rng.random(m) * cdf[-1]
    return np.minimum((cdf < u[None, :]).sum(0), w.shape[0] - 1)


def _draw_rows(w, rows, m, rng):
    """One column index per row ``rows`` of ``w``, drawn by its weights."""
    out = np.empty(m, np.int64)
    for r in np.unique(rows):
        at = np.flatnonzero(rows == r)
        out[at] = _draw(w[r], len(at), rng)
    return out


def _pair_draw(draw, given):
    """Two distinct indices per entry of ``given``, each from ``draw``."""
    m = len(given)
    a, b = np.empty(m, np.int64), np.empty(m, np.int64)
    todo = np.arange(m)
    while len(todo):
        a[todo] = draw(given[todo], len(todo))
        b[todo] = draw(given[todo], len(todo))
        todo = todo[a[todo] == b[todo]]
    return a, b


def sample_pairs(corpus: Corpus, p: dict, seed: int
                 ) -> Dict[str, List[tuple]]:
    """{'train': [...], 'dev': [...]} of 7-tuples (f1, s1, e1, f2, s2, e2,
    'same'|'diff'), as ``read_dataset`` returns a pair file."""
    rng = host_rng(seed, 3)
    train, dev = split_tokens(corpus, p, rng)
    n_train = int(p["n_pairs"] * p["ratio_train_dev"])
    keys = corpus.keys
    out = {}
    for split, toks, n in (("train", train, n_train),
                           ("dev", dev, p["n_pairs"] - n_train)):
        t1, t2, y = sample_split(toks, n, corpus, p, rng)
        out[split] = [keys[a] + keys[b] + ("same" if s else "diff",)
                      for a, b, s in zip(t1.tolist(), t2.tolist(),
                                         y.tolist())]
    return out
