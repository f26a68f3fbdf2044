"""The eval driver: whole passes of export -> distance matrix -> ABX.

A pass is what the grid search runs after a grid point: the embedder's
streaming export of the whole corpus (5,000-row chunks, fed from memory:
the card's machine has no h5py), a ``TokenBank`` of the item tokens cut
from the exported embeddings, ``distance_matrix(bank, "dtw_cos",
device_out=True)`` over them, and ``abx_error_device`` across and within
speakers. Set-up runs one pass at the cell's own shapes; the window runs
passes until ``seconds`` have passed. The last pass's outputs are held
for the check: the embeddings against the reference tower, a sample of
the distances against the reference DTW, the scores against the
reference ABX of the program's own matrix.

The export enters the embedder through ``_forward_fn`` and
``_embed_streaming``, the calls that its public ``embed`` makes between
reading and writing h5features files: the card's machine has no h5py,
and the program has no public entry that takes frames from memory.
The traced slice steps at the pass's stages (export, distances, scores)
and records the window's first pass whole; the tiles of a pass
are worked out from the item count and the tile side.
"""

from __future__ import annotations

import sys
import time
from typing import Dict

import numpy as np
import torch

from h100_bench.core import trace as tracing
from h100_bench.core.cell import kernel_counts
from h100_bench.core.corpus import (Laps, device_generator, host_rng,
                                    make_corpus)
from h100_bench.core.flops import ModelFlops
from h100_bench.kernels import peaks
from h100_bench.reference import abx as ref_abx
from h100_bench.reference import dtw, numerics

_U16 = 65535.0


def select_items(corpus, n: int, per_class: int, seed: int):
    """``n`` item tokens: classes in a random order, each giving up to
    ``per_class`` of its tokens (classes of one token give none)."""
    rng = host_rng(seed, 6)
    by_class = {}
    for t, c in enumerate(corpus.tok_class.tolist()):
        by_class.setdefault(c, []).append(t)
    items = []
    for c in rng.permutation(len(by_class)).tolist():
        toks = by_class[c]
        if len(toks) < 2:
            continue
        items += rng.permutation(toks)[:per_class].tolist()
        if len(items) >= n:
            break
    items = np.asarray(items[:n])
    return items


class AbxDriver:
    kind = "eval"

    def __init__(self, cell, seed: int, device, trace: bool, workdir: str):
        self.cell, self.seed, self.device = cell, seed, device
        self.trace, self.workdir = trace, workdir
        self.values = cell.config.values
        self.slice = None
        self.spans = {"export": 0.0, "distance": 0.0, "score": 0.0}
        self.passes = 0

    def setup(self) -> None:
        t = self.cell.traffic
        model, ref = self.cell.config.model, self.cell.config.reference
        lap = Laps()
        self.stages = lap.seconds
        self.corpus = c = make_corpus(t["corpus"], self.seed, self.device)
        lap("corpus")
        gen = device_generator(self.seed, 4, self.device)
        self.weights = ref.init_weights(self.values, gen, self.device)
        self.network = model.make_network(self.values, self.device)
        model.load_weights(self.network, self.weights)
        ev = t["eval"]
        if self.values.get("abx_n_tokens", ev["n_items"]) != ev["n_items"]:
            raise ValueError("the traffic's item count is not the "
                             "configuration's abx_n_tokens")
        self.items = select_items(c, ev["n_items"], ev["per_class"],
                                  self.seed)
        self.labels = c.tok_class[self.items]
        self.speakers = c.tok_speaker[self.items]
        self.embedder = model.make_embedder(self.values, self.network,
                                            self.device, ev["batch_size"])
        self.forward = self.embedder._forward_fn()
        self.n_frames = c.n_frames()
        self.item_len = lens = c.tok_len[self.items]
        s = float(lens.sum())
        needed = (s * s - float((lens.astype(np.float64) ** 2).sum())) / 2
        mf = ModelFlops(self.cell.config)
        dim_e = sum(ref.head_dims(self.values))
        self.pass_flops = (mf.export(self.n_frames)
                           + (2 * dim_e + 4) * needed)
        lap("network")
        self._run_pass()          # warm-up at the cell's own shapes
        lap("warm_pass")
        self.spans = {k: 0.0 for k in self.spans}
        self.passes = 0

    def _export(self):
        out = [None] * len(self.corpus.files)

        def done(i, labels, embs):
            out[i] = embs[0]
        self.embedder._embed_streaming(
            self.forward, ((i, None, f) for i, f in
                           enumerate(self.corpus.frames)), done)
        return out

    def _run_pass(self) -> None:
        from abnet3_torch.eval.abx import distance_matrix
        from abnet3_torch.eval.abx_device import abx_error_device
        from abnet3_torch.ops.bank import TokenBank
        c = self.corpus
        # the outputs of the pass before go first, so that each pass
        # reuses the memory of the last one, as after the set-up's pass
        self.last = None
        t0 = time.perf_counter()
        embs = self._export()
        t1 = time.perf_counter()
        self._stage()
        bank = TokenBank({k: embs[c.tok_file[t]][
            c.tok_start[t]:c.tok_start[t] + c.tok_len[t]]
            for k, t in enumerate(self.items.tolist())}, device=self.device)
        D, handle = distance_matrix(bank, "dtw_cos",
                                    batch_size=self.cell.traffic["eval"][
                                        "block"], device_out=True)
        t2 = time.perf_counter()
        self._stage()
        scores = {task: abx_error_device(handle, self.labels, self.speakers,
                                         task=task)
                  for task in ("across", "within")}
        t3 = time.perf_counter()
        self._stage()
        self.spans["export"] += t1 - t0
        self.spans["distance"] += t2 - t1
        self.spans["score"] += t3 - t2
        self.passes += 1
        self.last = {"embs": embs, "D": D, "scores": scores}
        print(f"pass {self.passes}: export {t1 - t0:.3f} s, distance "
              f"{t2 - t1:.3f} s, score {t3 - t2:.3f} s", file=sys.stderr,
              flush=True)

    def _stage(self) -> None:
        if self.slice is not None:
            self.slice.step()

    def tiles_per_pass(self) -> int:
        """Tiles of side ``block`` over the upper triangle of N items."""
        block = self.cell.traffic["eval"]["block"]
        t = -(-len(self.items) // block)
        return t * (t + 1) // 2

    def window(self, seconds: float) -> None:
        if self.trace:
            sl = self.cell.traffic["trace_slice"]
            self.slice = tracing.Slice(sl["skip"], sl["warmup"],
                                       sl["active"])
            self.slice.start()
            # empty steps before the window, so that the recording is
            # the first pass's stages
            for _ in range(sl["skip"] + sl["warmup"]):
                self.slice.step()
        t0 = time.perf_counter()
        self.mark = None
        try:
            while True:
                self._run_pass()
                if self.passes == 1:
                    # the traced slice lies in the first pass: the spans
                    # that the readers take start after it
                    self.mark = (time.perf_counter(), dict(self.spans))
                # a traced run reads the passes after the traced one
                if (time.perf_counter() - t0 >= seconds
                        and self.passes > int(self.trace)):
                    break
        finally:
            if self.slice is not None:
                self.slice.stop()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.t_window, self.t_end = t0, time.perf_counter()
        self.window_s = self.t_end - t0

    def end_to_end(self) -> Dict[str, float]:
        n = len(self.items)
        return {"eval_pairs_per_s": self.passes * n * (n - 1) / 2
                / self.window_s}

    def attempted(self):
        bad = sum(1 for s in self.last["scores"].values()
                  if not np.isfinite(s["error"]))
        return self.passes, bad

    def _stats_bound(self) -> float:
        """Mean least time of one stats launch over the pass's tiles."""
        kernel = kernel_counts("dtw_path_stats")
        block = self.cell.traffic["eval"]["block"]
        lens = self.item_len.tolist()
        blocks = [lens[i:i + block] for i in range(0, len(lens), block)]
        total, launches = 0.0, 0
        for bi in range(len(blocks)):
            for bj in range(bi, len(blocks)):
                for n1 in blocks[bi]:
                    total += kernel.bound_s(n1, blocks[bj])
                    launches += 1
        return total / launches

    def layer_data(self) -> dict:
        """What the per-layer readers read: the spans of the passes after
        the first (the traced one) when the window ran more than one, the
        traced slice, the stats kernel's bound."""
        t_mark, spans, passes = self.t_window, {}, 0
        if self.passes > 1:
            (t_mark, spans), passes = self.mark, 1
        n = self.passes - passes
        return {"export_s": self.spans["export"]
                - spans.get("export", 0.0),
                "distance_s": self.spans["distance"]
                - spans.get("distance", 0.0),
                "score_s": self.spans["score"] - spans.get("score", 0.0),
                "passes": n, "tiles": n * self.tiles_per_pass(),
                "flops": n * self.pass_flops,
                "window_s": self.t_end - t_mark,
                "peak_flops": peaks.FP32_FLOPS,
                "trace": self.slice.result if self.slice else None,
                "kernel_bounds": {"dtw_path_stats": self._stats_bound()}}

    # -- the check ---------------------------------------------------------

    def free(self) -> None:
        self.embedder = self.forward = self.network = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _check_frames(self):
        """(file, row) of the frames whose embeddings are compared: every
        frame of the item tokens and a sample of the corpus's."""
        c = self.corpus
        rng = host_rng(self.seed, 7)
        parts = [np.stack([np.full(n, f), s + np.arange(n)]) for f, s, n in
                 zip(c.tok_file[self.items], c.tok_start[self.items],
                     c.tok_len[self.items])]
        lens = np.asarray([len(f) for f in c.frames])
        files = rng.integers(0, len(lens), self.cell.traffic["eval"][
            "check_frames"])
        rows = (rng.random(len(files)) * lens[files]).astype(np.int64)
        parts.append(np.stack([files, rows]))
        return np.concatenate(parts, 1)

    def reference_embeddings(self, fr, tf32=False):
        ref = self.cell.config.reference
        x = np.stack([self.corpus.frames[f][r] for f, r in fr.T])
        out = []
        with numerics.tf32(tf32), torch.no_grad():
            for a in range(0, len(x), 65536):
                xb = torch.from_numpy(x[a:a + 65536]).to(self.device)
                out.append(ref.forward(self.values, self.weights, xb))
        return torch.cat(out)

    def _pairs(self):
        rng = host_rng(self.seed, 8)
        n = len(self.items)
        m = self.cell.traffic["eval"]["check_pairs"]
        i = rng.integers(0, n, m)
        j = rng.integers(0, n - 1, m)
        j += j >= i
        longest = np.argsort(self.item_len)[-2:]
        return (np.concatenate([i, longest[:1]]),
                np.concatenate([j, longest[1:]]))

    def reference_distances(self, emb_of_item, i, j):
        out = []
        for a in range(0, len(i), 1024):
            x1, n1 = dtw.pad([emb_of_item(k) for k in i[a:a + 1024]],
                             self.device)
            x2, n2 = dtw.pad([emb_of_item(k) for k in j[a:a + 1024]],
                             self.device)
            out.append(dtw.mean_path_distance(x1, n1, x2, n2))
        return torch.cat(out).cpu().numpy()

    def _item_embeddings(self, ref_emb):
        """Per item, its rows of the reference embeddings (items first in
        the compared frames)."""
        offs = np.concatenate([[0], np.cumsum(self.corpus.tok_len[
            self.items])])
        host = ref_emb.cpu().numpy()
        return lambda k: host[offs[k]:offs[k + 1]]

    def readings(self, tf32=False) -> dict:
        """The reference's embeddings and sampled distances (in TF32 for
        the control)."""
        fr = self._check_frames()
        emb = self.reference_embeddings(fr, tf32)
        i, j = self._pairs()
        dist = self.reference_distances(self._item_embeddings(emb), i, j)
        return {"emb": emb, "dist": dist}

    def program_readings(self) -> dict:
        fr = self._check_frames()
        embs = self.last["embs"]
        emb = torch.from_numpy(np.stack([embs[f][r] for f, r in fr.T]))
        i, j = self._pairs()
        return {"emb": emb.to(self.device),
                "dist": self.last["D"][i, j].astype(np.float64)}

    def numbers(self, side, ref) -> dict:
        """``emb_gap``: the largest gap of an embedding value;
        ``dist_codes_off``: the share of sampled distances whose u16 code
        is not the reference's (the program's matrix holds codes)."""
        codes = [np.round(np.clip(d, 0.0, 1.0) * _U16) for d in
                 (side["dist"], ref["dist"])]
        return {"emb_gap": float((side["emb"] - ref["emb"]).abs().max()),
                "dist_codes_off": float(np.mean(codes[0] != codes[1]))}

    def check(self) -> dict:
        out = self.numbers(self.program_readings(), self.readings())
        out.update(self.score_numbers(self.last["scores"]))
        return out

    def _reference_scores(self, dtype=torch.float64) -> dict:
        D = torch.from_numpy(self.last["D"]).to(self.device)
        lab = torch.from_numpy(np.asarray(self.labels)).to(self.device)
        spk = torch.from_numpy(np.asarray(self.speakers)).to(self.device)
        return {task: ref_abx.abx_error(D, lab, spk, task=task, dtype=dtype)
                for task in ("across", "within")}

    def score_numbers(self, scores: dict) -> dict:
        """``abx_gap``: the largest gap of an ABX error against the
        reference's on the program's own matrix; ``abx_count_mismatch``:
        cells and triplet counts that differ."""
        want = self._reference_scores()
        gap = max(abs(scores[t]["error"] - want[t]["error"]) for t in want)
        off = sum((scores[t]["n_cells"] != want[t]["n_cells"])
                  + (scores[t]["n_triplets"] != want[t]["n_triplets"])
                  for t in want)
        return {"abx_gap": gap, "abx_count_mismatch": float(off)}

    def control_readings(self) -> dict:
        """The control: the reference's tower in TF32 against its float32
        run, and the reference scorer with its cells summed in float32
        (the program's scorer sums in float64) on the program's matrix."""
        ref = self.readings()
        out = self.numbers(self.readings(tf32=True), ref)
        out.update(self.score_numbers(self._reference_scores(
            torch.float32)))
        return {"control_tf32": out}
