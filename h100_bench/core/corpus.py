"""The synthetic word corpus every traffic mix draws on, made from a seed.

Each class is a prototype sequence of frames; each token is a
time-warped copy of its class's prototype, with its speaker's offset and
noise, so same-class pairs align near the diagonal as spoken words do.
The host draws the inventory (class sizes, speakers, lengths, warps,
file layout) with numpy; the frames are drawn on the device with a
``torch.Generator`` in a few large calls and copied to the host once,
file by file contiguous. The same seed gives the same corpus.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch


def host_rng(seed: int, tag: int) -> np.random.Generator:
    """A numpy generator for one purpose (``tag``) of a run's seed (any
    non-negative integer, beyond 32 bits too)."""
    return np.random.default_rng(np.random.SeedSequence(
        [seed & 0xFFFFFFFF, seed >> 32, tag]))


def device_generator(seed: int, tag: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(host_rng(seed, tag).integers(0, 2 ** 63 - 1)))
    return g


class Laps:
    """Seconds of each named stage of set-up, for standard error."""

    def __init__(self):
        self.seconds = {}
        self._t = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self._t
        self._t = now


@dataclass
class Corpus:
    """Files of frames (host float32, one array per file, frame i at time
    i) and the token table: for token t its file index, first frame,
    length, class and speaker. ``keys[t]`` is its (file, start, end)
    bound triple as a pair file names it (end inclusive)."""
    files: List[str]
    frames: List[np.ndarray]
    times: List[np.ndarray]
    file_speaker: np.ndarray
    tok_file: np.ndarray
    tok_start: np.ndarray
    tok_len: np.ndarray
    tok_class: np.ndarray
    tok_speaker: np.ndarray

    @property
    def keys(self) -> List[Tuple[str, float, float]]:
        return [(self.files[f], float(s), float(s + n - 1))
                for f, s, n in zip(self.tok_file.tolist(),
                                   self.tok_start.tolist(),
                                   self.tok_len.tolist())]

    def key_index(self) -> Dict[Tuple[str, float, float], int]:
        return {k: i for i, k in enumerate(self.keys)}

    def token(self, t: int) -> np.ndarray:
        s = int(self.tok_start[t])
        return self.frames[int(self.tok_file[t])][s:s + int(self.tok_len[t])]

    def n_frames(self) -> int:
        return sum(len(f) for f in self.frames)

    def fid2spk(self) -> Dict[str, str]:
        return {f: f"spk{int(s):02d}"
                for f, s in zip(self.files, self.file_speaker)}


def make_corpus(p: dict, seed: int, device, chunk_frames: int = 1 << 18
                ) -> Corpus:
    rng = host_rng(seed, 1)
    n, C, S = p["n_tokens"], p["n_classes"], p["n_speakers"]
    dim, P = p["dim"], p["proto_len"]
    # class sizes: at least min_class_size each, the rest Zipf-weighted
    w = (np.arange(C) + 1.0) ** -p["class_zipf"]
    extra = rng.multinomial(n - C * p["min_class_size"], w / w.sum())
    tok_class = np.repeat(np.arange(C), p["min_class_size"] + extra)
    tok_speaker = rng.integers(0, S, n)
    tok_len = rng.integers(p["min_len"], p["max_len"] + 1, n)
    warp = np.exp(rng.normal(0.0, p["warp"], n))
    # files: each speaker's tokens in a random order, tokens_per_file a file
    files, file_speaker, tok_file = [], [], np.zeros(n, np.int64)
    order = []
    for s in range(S):
        mine = rng.permutation(np.flatnonzero(tok_speaker == s))
        for k, c0 in enumerate(range(0, len(mine), p["tokens_per_file"])):
            chunk = mine[c0:c0 + p["tokens_per_file"]]
            tok_file[chunk] = len(files)
            files.append(f"s{s:02d}f{k:03d}")
            file_speaker.append(s)
            order.append(chunk)
    order = np.concatenate(order)
    # frames in file order; each token's first frame within its file
    lens = tok_len[order]
    global_start = np.concatenate([[0], np.cumsum(lens)[:-1]])
    file_of = tok_file[order]
    file_first = np.full(len(files), len(order), np.int64)
    np.minimum.at(file_first, file_of, np.arange(len(order)))
    file_first = global_start[file_first]
    tok_start = np.zeros(n, np.int64)
    tok_start[order] = global_start - file_first[file_of]
    total = int(lens.sum())

    gen = device_generator(seed, 2, device)
    protos = torch.randn((C, P, dim), generator=gen, device=device)
    offsets = torch.randn((S, dim), generator=gen, device=device) \
        * p["speaker_scale"]
    # per frame: token (in file order), position on the prototype
    tok_of_frame = torch.from_numpy(np.repeat(order, lens)).to(device)
    t_in_tok = torch.from_numpy(
        np.arange(total) - np.repeat(global_start, lens)).to(device)
    n_of = torch.from_numpy(tok_len).to(device)[tok_of_frame]
    g_of = torch.from_numpy(warp).to(device)[tok_of_frame]
    u = (t_in_tok.double() / (n_of - 1).clamp(min=1).double()) ** g_of
    pos = (u * (P - 1)).float()
    lo = pos.floor().long().clamp(max=P - 2)
    frac = (pos - lo.float())[:, None]
    cls = torch.from_numpy(tok_class).to(device)[tok_of_frame]
    spk = torch.from_numpy(tok_speaker).to(device)[tok_of_frame]
    out = torch.empty((total, dim), dtype=torch.float32, device=device)
    for a in range(0, total, chunk_frames):
        b = min(a + chunk_frames, total)
        c, l_, f = cls[a:b], lo[a:b], frac[a:b]
        out[a:b] = (protos[c, l_] * (1 - f) + protos[c, l_ + 1] * f
                    + offsets[spk[a:b]]
                    + p["noise"] * torch.randn((b - a, dim), generator=gen,
                                               device=device))
    host = out.cpu().numpy()
    del out, protos
    bounds = np.concatenate([[0], np.cumsum(np.bincount(
        file_of, weights=lens, minlength=len(files)).astype(np.int64))])
    frames = [host[bounds[i]:bounds[i + 1]] for i in range(len(files))]
    times = [np.arange(len(f), dtype=np.float64) for f in frames]
    return Corpus(files, frames, times, np.asarray(file_speaker), tok_file,
                  tok_start, tok_len, tok_class, tok_speaker)
