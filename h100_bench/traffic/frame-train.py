"""The frame-level train mix: ``MultimodalDataLoader`` batches of aligned
frame pairs against one device table per modality, through the train
driver, which with ``--trace 1`` also reads the program's spans and
counters (``core/spans.py``).

The core driver counts token pairs; here the unit is the frame pair. The
loader aligns every pair once at set-up (on modality A, the ``dtw_moves``
kernel and the walk) and yields ``FrameBankBatch``es of row indices into
its tables; a frame pair of weight > 0 is what a step trains on, and what
``train_pairs_per_s`` counts. What this file adds to the core's driver:

- modality B (:func:`modality_b`): the corpus's files, tokens and frame
  counts and its tokens' time warps, with class prototypes, speaker
  offsets and noise of its own (``corpora/<corpus_b>.json``), drawn from
  the seed under a tag of its own;
- the rows' map back to (token, frame): the loader lays a split's table
  out token by token in the order the split's pairs first name them
  (same pairs, then different ones; each pair's first token first), which
  set-up checks against the loader's host tables of both modalities;
- the check at the frame level: each held row of weight > 0 is a cell of
  the reference DTW path of a train same pair (label +1) or a diagonal
  frame of a train different pair (-1), else it counts in ``bad_pairs``;
  at set-up, the loader's whole train set of frame pairs holds every
  train pair whole, else ``pairs_not_whole`` counts it
  (:meth:`FrameTrainDriver.pairs_not_whole`);
  the reference takes both modalities' frames from the harness's corpus
  and steps with the gate's parameters at their own learning rate; two
  more numbers, ``grad_gap_attention`` and ``update_gap_attention``, are
  the gaps at the worst of the gate's leaves;
- a planted fault of the mechanism: the reference's gate held at 0.5;
- FLOPs per frame pair: every tower on both frames (3x in training), the
  cosine; the window aligns nothing.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Dict, List

import numpy as np
import torch

from h100_bench.core import check as checks
from h100_bench.core.corpus import (Laps, device_generator, host_rng,
                                    make_corpus)
from h100_bench.core.pairs import sample_pairs
from h100_bench.core.spans import ReadsSpans
from h100_bench.core.train import Feed, TrainDriver
from h100_bench.reference import dtw, numerics

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the seed's tag of modality B's draws, used by no other draw
TAG_B = 19
#: the seed's tag of the same pairs whose path cost set-up checks
TAG_SAMPLE = 20
#: same pairs a set-up checks against the reference DTW's optimum
SAMPLE_SAME = 2048
#: a whole path's cost under the reference distance, relative to the
#: reference optimum's: room for the program's distance rounding (~1e-7
#: a cell) and far below the cost of a dropped cell (a distance of ~0.3)
PATH_COST_RTOL = 1e-5
INPUT_LEAF = "pre_0/layer_0/w"


def _warps(p: dict, seed: int, corpus) -> np.ndarray:
    """The time warp ``make_corpus`` drew for each token: its inventory
    draws again, in its order (checked against the corpus it made)."""
    rng = host_rng(seed, 1)
    n, C, S = p["n_tokens"], p["n_classes"], p["n_speakers"]
    w = (np.arange(C) + 1.0) ** -p["class_zipf"]
    rng.multinomial(n - C * p["min_class_size"], w / w.sum())
    speaker = rng.integers(0, S, n)
    length = rng.integers(p["min_len"], p["max_len"] + 1, n)
    warp = np.exp(rng.normal(0.0, p["warp"], n))
    if not (np.array_equal(speaker, corpus.tok_speaker)
            and np.array_equal(length, corpus.tok_len)):
        raise RuntimeError("make_corpus draws its inventory otherwise: "
                           "modality B cannot take its tokens' warps")
    return warp


def modality_b(corpus, p_a: dict, p: dict, seed: int, device,
               chunk_frames: int = 1 << 18) -> List[np.ndarray]:
    """Modality B's frames, one host float32 array per file of ``corpus``
    with the same frame count: a token's frames follow its class's own
    prototype on the token's time warp, plus its speaker's own offset and
    noise."""
    warp = _warps(p_a, seed, corpus)
    dim, P = p["dim"], p["proto_len"]
    C = int(corpus.tok_class.max()) + 1
    S = int(corpus.tok_speaker.max()) + 1
    file_len = np.array([len(f) for f in corpus.frames], np.int64)
    file_base = np.concatenate([[0], np.cumsum(file_len)[:-1]])
    start = file_base[corpus.tok_file] + corpus.tok_start
    order = np.argsort(start, kind="stable")
    lens = corpus.tok_len[order]
    total = int(file_len.sum())
    if int(lens.sum()) != total:
        raise RuntimeError("the corpus's files are not made of its tokens")
    gen = device_generator(seed, TAG_B, device)
    protos = torch.randn((C, P, dim), generator=gen, device=device)
    offsets = torch.randn((S, dim), generator=gen, device=device) \
        * p["speaker_scale"]
    tok_of_frame = torch.from_numpy(np.repeat(order, lens)).to(device)
    t_in_tok = torch.from_numpy(
        np.arange(total) - np.repeat(start[order], lens)).to(device)
    n_of = torch.from_numpy(corpus.tok_len).to(device)[tok_of_frame]
    g_of = torch.from_numpy(warp).to(device)[tok_of_frame]
    u = (t_in_tok.double() / (n_of - 1).clamp(min=1).double()) ** g_of
    pos = (u * (P - 1)).float()
    lo = pos.floor().long().clamp(max=P - 2)
    frac = (pos - lo.float())[:, None]
    cls = torch.from_numpy(corpus.tok_class).to(device)[tok_of_frame]
    spk = torch.from_numpy(corpus.tok_speaker).to(device)[tok_of_frame]
    host = np.empty((total, dim), np.float32)
    for a in range(0, total, chunk_frames):
        b = min(a + chunk_frames, total)
        c, l_, f = cls[a:b], lo[a:b], frac[a:b]
        host[a:b] = (protos[c, l_] * (1 - f) + protos[c, l_ + 1] * f
                     + offsets[spk[a:b]]
                     + p["noise"] * torch.randn((b - a, dim), generator=gen,
                                                device=device)).cpu().numpy()
    return [host[s:s + n] for s, n in zip(file_base, file_len)]


class Batches:
    """``FrameBankBatch``es: rows (i1, i2) of the split's tables, labels
    and weights on the batch."""

    def __init__(self, driver, spec: dict):
        pass

    def count(self, b) -> int:
        return int((b.weights > 0).sum())

    def pairs(self, b):
        """The batch's rows (i1, i2, y, w), copied."""
        return b.i1.copy(), b.i2.copy(), b.y.copy(), b.weights.copy()

    def release(self, b) -> None:
        pass

    def kernel_shapes(self, b, n1, n2) -> dict:
        return {}


class FrameFlops:
    """Model FLOPs of frame pairs: every tower on both frames (forward,
    and in training the backward at twice the forward) and the cosine of
    the two embeddings."""

    def __init__(self, config):
        ref = config.reference
        self.frame = 2 * sum(a * b for a, b in
                             ref.shapes(config.values).values())
        self.head = sum(ref.head_dims(config.values))

    def pairs(self, n: int, train: bool) -> float:
        k = 3.0 if train else 1.0
        return k * (2 * self.frame + 2 * self.head) * n


class FrameFeed(Feed):
    def _count(self, b, train_mode: bool) -> None:
        self.flops[train_mode] += self.d.model_flops.pairs(
            self.batches.count(b), train_mode)


class FrameTrainDriver(TrainDriver):
    """The train driver on frame-pair batches of two modalities."""

    def setup(self) -> None:
        from h100_bench.core.cell import _load_json
        t = self.cell.traffic
        model, ref = self.cell.config.model, self.cell.config.reference
        lap = Laps()
        self.stages = lap.seconds
        self.corpus = make_corpus(t["corpus"], self.seed, self.device)
        lap("corpus")
        p_b = _load_json(os.path.join(HERE, "corpora",
                                      f"{t['corpus_b']}.json"))
        self.frames_b = modality_b(self.corpus, t["corpus"], p_b, self.seed,
                                   self.device)
        lap("modality_b")
        self.pairs = sample_pairs(self.corpus, t["pairs"], self.seed)
        lap("pairs")
        self.key_index = self.corpus.key_index()
        gen = device_generator(self.seed, 4, self.device)
        self.weights = ref.init_weights(self.values, gen, self.device)
        self.network = model.make_network(self.values, self.device)
        model.load_weights(self.network, self.weights)
        self.paths = model.param_paths(self.network)
        c = self.corpus
        times = dict(zip(c.files, c.times))
        features = [(times, dict(zip(c.files, c.frames))),
                    (times, dict(zip(c.files, self.frames_b)))]
        loader_seed = int(host_rng(self.seed, 5).integers(0, 2 ** 32 - 1))
        self.loader = model.make_loader(
            self.values, t["loader"], features, self.pairs, loader_seed,
            self.device, self.workdir, c.fid2spk())
        lap("loader")
        self._map_rows()
        self.not_whole = self.pairs_not_whole()
        lap("check_pairs")
        self.trainer = model.make_trainer(self.values, self.network,
                                          self.loader, self.seed,
                                          self.device, self.workdir)
        self.trainer.train_losses, self.trainer.dev_losses = [], []
        self.model_flops = FrameFlops(self.cell.config)
        self.kernels = {}
        self.batches = Batches(self, t["batches"])
        self.feed = FrameFeed(self, self.batches, detail=self.trace)
        self._watch()
        lap("trainer")
        self._first_steps()
        lap("first_steps")

    def _map_rows(self) -> None:
        """Each row of the train tables as (token, frame), by the loader's
        layout; ``layout_ok`` whether its host tables of both modalities
        hold those frames."""
        ki, c = self.key_index, self.corpus
        known = {"same": Counter(), "diff": Counter()}
        order = {}          # token -> None, in the order of first mention
        for kind in ("same", "diff"):
            for p in self.pairs["train"]:
                if p[6] == kind:
                    t1, t2 = ki[p[:3]], ki[p[3:6]]
                    known[kind][t1, t2] += 1
                    order.setdefault(t1)
                    order.setdefault(t2)
        order = np.fromiter(order, np.int64, len(order))
        lens = c.tok_len[order]
        self.row_token = np.repeat(order, lens)
        self.row_frame = (np.arange(int(lens.sum()))
                          - np.repeat(np.cumsum(lens) - lens, lens))
        self.train_pairs = known
        self.same_train, self.diff_train = set(known["same"]), \
            set(known["diff"])
        tables = self.loader.token_tables["train"]
        self.layout_ok = all(len(t) == len(self.row_token) for t in tables)
        at = 0
        for tok, n in zip(order.tolist(), lens.tolist()):
            if not self.layout_ok:
                break
            for table, frames in zip(tables, (c.frames, self.frames_b)):
                s = int(c.tok_start[tok])
                want = frames[int(c.tok_file[tok])][s:s + n]
                self.layout_ok &= np.array_equal(table[at:at + n], want)
            at += n

    def _first_steps(self) -> None:
        loader = self.loader
        full = loader.max_batches_per_epoch
        loader.max_batches_per_epoch = \
            self.cell.traffic["first_steps"]["batches"]
        self._hold()
        try:
            self.trainer.optimize_model(do_training=True)
        finally:
            loader.max_batches_per_epoch = full
        if not self.capture.full:
            raise RuntimeError(f"set-up ran {len(self.capture.steps)} "
                               "train steps; the check needs 3")
        self.capture = None
        self.feed.reset()
        torch.cuda.synchronize() if self.device.type == "cuda" else None

    # -- the check ---------------------------------------------------------

    def _rows(self, rows):
        """(token, frame) of each table row; -1 where there is none."""
        rows = np.asarray(rows, np.int64)
        ok = (rows >= 0) & (rows < len(self.row_token))
        safe = np.where(ok, rows, 0)
        return (np.where(ok, self.row_token[safe], -1),
                np.where(ok, self.row_frame[safe], -1))

    def _aligned(self, pairs):
        """(pair, its (T1, T2) float64 reference distances, (i, j) of its
        reference DTW path) of each token pair, on modality A."""
        c = self.corpus
        pairs = sorted(pairs)
        for k in range(0, len(pairs), 256):
            chunk = pairs[k:k + 256]
            x1, n1 = dtw.pad([c.token(a) for a, _ in chunk], self.device)
            x2, n2 = dtw.pad([c.token(b) for _, b in chunk], self.device)
            d = dtw.angular_distance(x1, x2)
            _, _, moves = dtw.dp(d, n1, n2)
            d = d.double().cpu().numpy()
            yield from zip(chunk, d, dtw.path_cells(
                moves, n1.cpu().numpy(), n2.cpu().numpy()))

    def _paths(self, pairs) -> Dict[tuple, set]:
        """The reference DTW path's cells of each token pair."""
        return {pair: set(zip(i.tolist(), j.tolist()))
                for pair, _, (i, j) in self._aligned(pairs)}

    def pairs_not_whole(self) -> int:
        """Train word pairs that the loader's train set of frame pairs
        does not hold whole, plus its rows of no train pair with their
        label. A different pair is whole with its diagonal frames 0 ..
        min(n1, n2) - 1, a same pair with one monotone path of unit steps
        from (0, 0) to (n1 - 1, n2 - 1), each cell as many times as the
        pair is listed. For a seeded sample of ``SAMPLE_SAME`` whole same
        pairs the path's cost under the reference distance must also be
        the reference DTW's optimum (``PATH_COST_RTOL``): an optimal path
        less a cell is either no path or a cheaper one. The cost, not the
        cells, is compared, so that a near tie that the program's
        rounding breaks the other way counts nothing."""
        fp = np.asarray(self.loader.frame_pairs["train"], np.int64)
        if not self.layout_ok:
            return len(fp)
        t1, f1 = self._rows(fp[:, 0])
        t2, f2 = self._rows(fp[:, 1])
        y = fp[:, 2]
        lens = self.corpus.tok_len
        off = int(((t1 < 0) | (t2 < 0) | (np.abs(y) != 1)
                   | ((y == -1) & (f1 != f2))).sum())
        whole = {}
        for kind, label in (("same", 1), ("diff", -1)):
            want = self.train_pairs[kind]
            m = (t1 >= 0) & (t2 >= 0) & (y == label) & ((label > 0)
                                                         | (f1 == f2))
            held, surplus = self._held_cells(want, t1[m], f1[m], t2[m],
                                             f2[m])
            off += surplus
            for pair, times in want.items():
                n1, n2 = lens[pair[0]], lens[pair[1]]
                cells, k = held.get(pair, (None, None))
                if cells is None or (k != times).any():
                    off += 1
                    continue
                i, j = cells
                if label < 0:
                    ok = np.array_equal(i, np.arange(min(n1, n2)))
                else:
                    di, dj = np.diff(i), np.diff(j)
                    ok = bool(i[0] == 0 and j[0] == 0 and i[-1] == n1 - 1
                              and j[-1] == n2 - 1
                              and ((di <= 1) & (dj >= 0) & (dj <= 1)).all())
                    if ok:
                        whole[pair] = cells
                off += not ok
        pool = sorted(whole)
        pick = host_rng(self.seed, TAG_SAMPLE).choice(
            len(pool), min(SAMPLE_SAME, len(pool)), replace=False)
        for pair, d, (i, j) in self._aligned([pool[k] for k in pick]):
            best, cost = d[i, j].sum(), d[tuple(whole[pair])].sum()
            off += bool(abs(cost - best) > PATH_COST_RTOL * best)
        return off

    def _held_cells(self, want, t1, f1, t2, f2):
        """({(token 1, token 2): ((2, n) cells (i, j) in increasing order,
        (n,) times each is held)} of the rows of the pairs in ``want``,
        and the count of rows of no such pair)."""
        n_tok = np.int64(len(self.corpus.tok_len))
        F = np.int64(int(self.corpus.tok_len.max()) + 1)
        key, n = np.unique(((t1 * n_tok + t2) * F + f1) * F + f2,
                           return_counts=True)
        pk, cell = key // (F * F), key % (F * F)
        wanted = np.isin(pk, np.array([a * n_tok + b for a, b in want],
                                      np.int64))
        surplus = int(n[~wanted].sum())
        pk, cell, n = pk[wanted], cell[wanted], n[wanted]
        if not len(pk):
            return {}, surplus
        cut = np.flatnonzero(np.diff(pk)) + 1
        return {divmod(int(p[0]), int(n_tok)): (np.stack([c // F, c % F]), k)
                for p, c, k in zip(np.split(pk, cut), np.split(cell, cut),
                                   np.split(n, cut))}, surplus

    def bad_pairs(self) -> int:
        """Held rows of weight > 0 that are no cell of a train pair's
        alignment with its label: a same row off the reference DTW path of
        a train same pair, a different row off the diagonal of a train
        different pair."""
        rows = []
        for cap in self.held:
            for (i1, i2, y, w), _ in cap.steps:
                m = w > 0
                rows.append((*self._rows(i1[m]), *self._rows(i2[m]), y[m]))
        if not self.layout_ok:
            return sum(len(r[-1]) for r in rows)
        want = {(a, b) for t1, _, t2, _, y in rows
                for a, b, s in zip(t1.tolist(), t2.tolist(), y.tolist())
                if s > 0 and (a, b) in self.same_train}
        paths = self._paths(want)
        bad = 0
        for t1, f1, t2, f2, y in rows:
            for a, i, b, j, s in zip(t1.tolist(), f1.tolist(), t2.tolist(),
                                     f2.tolist(), y.tolist()):
                if s > 0:
                    bad += (i, j) not in paths.get((a, b), ())
                else:
                    bad += (a, b) not in self.diff_train or i != j or i < 0
        return bad

    def reference_batches(self, cap, keep_half: bool = False):
        """The reference's frames of the held steps: the rows of weight >
        0 (``keep_half``: every other one), both modalities from the
        harness's corpus."""
        ref, c = self.cell.config.reference, self.corpus
        out = []
        for (i1, i2, y, w), _ in cap.steps:
            m = np.flatnonzero(w > 0)
            if keep_half:
                m = m[::2]
            sides = []
            for rows in (i1[m], i2[m]):
                tok, fr = self._rows(rows)
                start = c.tok_start[tok] + fr
                for frames in (c.frames, self.frames_b):
                    sides.append(np.stack([frames[f][s] for f, s in zip(
                        c.tok_file[tok].tolist(), start.tolist())]))
            xa1, xb1, xa2, xb2 = (torch.from_numpy(a).to(self.device)
                                  for a in sides)
            out.append(ref.Frames(xa1, xb1, xa2, xb2, torch.from_numpy(
                y[m].astype(np.float32)).to(self.device)))
        return out

    def reference_readings(self, cap, tf32: bool = False,
                           keep_half: bool = False, fixed_gate=None) -> dict:
        ref = self.cell.config.reference
        with numerics.tf32(tf32):
            r = ref.run_steps(self.values, cap.start,
                              self.reference_batches(cap, keep_half),
                              state=cap.start_state, fixed_gate=fixed_gate)
        return {"losses": r["losses"],
                "grad_norms": {k: float(g.double().norm())
                               for k, g in r["first_grad"].items()},
                "update_norms": {k: float((r["params"][k]
                                           - cap.start[k]).double()
                                          .norm())
                                 for k in r["params"]}}

    def check(self) -> dict:
        return dict(super().check(), pairs_not_whole=float(self.not_whole))

    def numbers(self, side: dict, ref: dict) -> dict:
        out = checks.train_numbers(side, ref, INPUT_LEAF)
        att = [k for k in ref["grad_norms"]
               if self.cell.config.reference.is_attention(k)]
        for part in ("grad", "update"):
            out[f"{part}_gap_attention"] = max(checks._leaf_gaps(
                side[f"{part}_norms"], ref[f"{part}_norms"], att))
        return out

    def control_readings(self) -> dict:
        """The control (the reference in TF32) and the faults planted in
        the reference (half of each batch left out; the gate held at 0.5),
        each against the float32 reference over the held steps."""
        out = {}
        for name, kw in (("control_tf32", {"tf32": True}),
                         ("fault_half_batch", {"keep_half": True}),
                         ("fault_fixed_gate", {"fixed_gate": 0.5})):
            parts = self.held_numbers(
                lambda cap: self.reference_readings(cap, **kw))
            out[name] = dict(checks.worst(parts), bad_pairs=0.0,
                             pairs_not_whole=0.0)
        return out


class Driver(ReadsSpans, FrameTrainDriver):
    rounds = "epochs"
