"""The train driver: whole epochs of ``optimize_model(do_training=True)``.

Set-up makes the corpus, the pairs and the weights from the seed, builds
the configuration's network, loader and trainer (its ``model.py``), and
runs one short epoch through the window's own call and feed (the
loader's ``num_max_minibatches`` cut to the traffic's
``first_steps.batches``): it builds and warms every kernel the cell uses
and holds the first three train steps for the check. The window then
runs whole epochs (a train pass and its dev pass) until ``seconds`` have
passed and divides the train pairs by all of its time. At the start of
each epoch the driver copies the parameters and the optimizer's state
and holds that epoch's first three train steps, so that the check also
follows the window's last epoch from where it began.

The harness's own wrappers, installed on the program's objects from
here, count and time what the window feeds: the loader's
``batch_iterator`` (the pairs of each train batch, through the traffic's
kind of batches, ``core/batches.py``; with tracing the time of each
``next()``), the trainer's ``give_batch_to_network`` (the steps each
call ran, from the losses it returns) and the optimizer's ``step`` (the
state after a held epoch's first step).
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List

import numpy as np
import torch

from h100_bench.core import check as checks
from h100_bench.core import trace as tracing
from h100_bench.core.batches import batches_for
from h100_bench.core.corpus import (Laps, device_generator, host_rng,
                                    make_corpus)
from h100_bench.core.flops import ModelFlops
from h100_bench.core.pairs import sample_pairs
from h100_bench.kernels import peaks
from h100_bench.reference import numerics, train_step


def _bucket_key(b):
    return (type(b).__name__, getattr(b, "bucket", None),
            getattr(b, "mode", None))


class Feed:
    """Wraps the loader's batch stream: train pairs counted always; with
    ``detail`` each batch's build time, its pairs' lengths (FLOPs) and
    the kernel bounds of its steps."""

    def __init__(self, driver, batches, detail: bool):
        self.d = driver
        self.batches = batches
        self.detail = detail
        self.train_pairs = 0
        self.steps = {True: 0, False: 0}
        self.build_s: List[float] = []
        self.flops = {True: 0.0, False: 0.0}
        self.bounds: Dict[str, List[float]] = {}
        loader = driver.loader
        orig_iter = loader.batch_iterator

        def batch_iterator(train_mode=True):
            it = orig_iter(train_mode=train_mode)
            while True:
                t0 = time.perf_counter()
                try:
                    b = next(it)
                except StopIteration:
                    return
                dt = time.perf_counter() - t0
                self.note(b, train_mode, dt)
                yield b
        loader.batch_iterator = batch_iterator

    def reset(self) -> None:
        self.train_pairs = 0
        self.steps = {True: 0, False: 0}
        self.build_s.clear()
        self.flops = {True: 0.0, False: 0.0}
        self.bounds.clear()

    def note(self, b, train_mode: bool, dt: float) -> None:
        n = self.batches.count(b)
        self.steps[train_mode] += 1
        if train_mode:
            self.train_pairs += n
        if self.detail:
            if train_mode:
                self.build_s.append(dt)
            self._count(b, train_mode)

    def _count(self, b, train_mode: bool) -> None:
        same, diff = self.batches.pairs(b)
        lens = self.d.length_of
        n1 = [lens[a] for a, _ in same] + [lens[a] for a, _ in diff]
        n2 = [lens[c] for _, c in same] + [lens[c] for _, c in diff]
        flags = [True] * len(same) + [False] * len(diff)
        self.flops[train_mode] += self.d.model_flops.pairs(n1, n2, flags,
                                                           train_mode)
        s1, s2 = n1[:len(same)], n2[:len(same)]
        if not same:
            return
        shapes = self.batches.kernel_shapes(b, s1, s2)
        for name, kernel in self.d.kernels.items():
            if name in shapes:
                self.bounds.setdefault(name, []).append(
                    kernel.bound_s(s1, s2, *shapes[name]))


class Capture:
    """The first ``n`` train steps from a copy of the parameters and the
    optimizer's state: each step's pairs and loss, the optimizer's
    ``square_avg`` after step 1 and the parameters after step ``n``."""

    def __init__(self, driver, n: int):
        self.d, self.n = driver, n
        opt = driver.trainer.optimizer
        self.start = {k: p.detach().clone() for k, p in driver.paths.items()}
        self.start_state = {}
        for k, p in driver.paths.items():
            st = opt.state.get(p, {})
            self.start_state[k] = tuple(
                st[s].detach().clone() if s in st else torch.zeros_like(p)
                for s in ("square_avg", "acc_delta"))
        self.steps, self.pending = [], {}
        self.calls = 0
        self.state1 = self.params_n = None

    @property
    def full(self) -> bool:
        return len(self.steps) >= self.n and self.params_n is not None

    def given(self, batch, do_training: bool, out) -> None:
        if not do_training or len(self.steps) >= self.n:
            return
        buf = self.pending.setdefault(_bucket_key(batch), [])
        buf.append(self.d.batches.pairs(batch))
        if out:
            if len(out) != len(buf):
                raise RuntimeError(f"{len(out)} losses for {len(buf)} "
                                   "buffered batches")
            room = self.n - len(self.steps)
            self.steps += [(pairs, float(loss)) for pairs, loss in
                           list(zip(buf, out))[:room]]
            buf.clear()

    def stepped(self) -> None:
        self.calls += 1
        opt = self.d.trainer.optimizer
        if self.calls == 1:
            # no state: a step that left it unchanged reads zeros
            self.state1 = {k: opt.state.get(p, {}).get(
                "square_avg", torch.zeros_like(p)).detach().clone()
                for k, p in self.d.paths.items()}
        if self.calls == self.n:
            self.params_n = {k: p.detach().clone()
                             for k, p in self.d.paths.items()}


class TrainDriver:
    kind = "train"

    def __init__(self, cell, seed: int, device, trace: bool, workdir: str):
        self.cell, self.seed, self.device = cell, seed, device
        self.trace, self.workdir = trace, workdir
        self.values = cell.config.values
        self.kernels = {}
        self.slice = None
        self.capture = None
        self.held = []

    # -- set-up ------------------------------------------------------------

    def setup(self) -> None:
        t = self.cell.traffic
        model, ref = self.cell.config.model, self.cell.config.reference
        lap = Laps()
        self.stages = lap.seconds
        self.corpus = make_corpus(t["corpus"], self.seed, self.device)
        lap("corpus")
        self.pairs = sample_pairs(self.corpus, t["pairs"], self.seed)
        lap("pairs")
        self.key_index = self.corpus.key_index()
        self.length_of = {k: int(n) for k, n in
                          zip(self.corpus.keys, self.corpus.tok_len)}
        gen = device_generator(self.seed, 4, self.device)
        self.weights = ref.init_weights(self.values, gen, self.device)
        self.network = model.make_network(self.values, self.device)
        model.load_weights(self.network, self.weights)
        self.paths = model.param_paths(self.network)
        c = self.corpus
        features = (dict(zip(c.files, c.times)), dict(zip(c.files,
                                                          c.frames)))
        loader_seed = int(host_rng(self.seed, 5).integers(0, 2 ** 32 - 1))
        self.loader = model.make_loader(
            self.values, t["loader"], features, self.pairs, loader_seed,
            self.device, self.workdir, c.fid2spk())
        lap("loader")
        self.trainer = model.make_trainer(self.values, self.network,
                                          self.loader, self.seed,
                                          self.device, self.workdir)
        # what train() starts with; the window calls optimize_model alone
        self.trainer.train_losses, self.trainer.dev_losses = [], []
        self.model_flops = ModelFlops(self.cell.config)
        from h100_bench.core.cell import kernel_counts
        self.kernels = {name: kernel_counts(name)
                        for name in t.get("kernels", [])}
        self.batches = batches_for(self)
        self.feed = Feed(self, self.batches, detail=self.trace)
        self._watch()
        lap("trainer")
        self._first_steps()
        lap("first_steps")

    def _watch(self) -> None:
        """The harness's wrappers of ``give_batch_to_network`` and of the
        optimizer's ``step``, for set-up and window alike."""
        trainer, opt = self.trainer, self.trainer.optimizer
        give, step = trainer.give_batch_to_network, opt.step

        def given(batch, do_training):
            out = give(batch, do_training)
            if self.capture is not None:
                self.capture.given(batch, do_training, out)
            self.batches.release(batch)
            if self.slice is not None:
                self.slice.step(len(out) if do_training and out else 0)
            return out

        def stepped(*a, **kw):
            r = step(*a, **kw)
            if self.capture is not None:
                self.capture.stepped()
            return r
        trainer.give_batch_to_network = given
        opt.step = stepped

    def _hold(self) -> None:
        """Copy the state and hold the next three train steps."""
        self.capture = Capture(self, 3)
        self.held = self.held[:1] + [self.capture]

    def _first_steps(self) -> None:
        n_batches = self.cell.traffic["first_steps"]["batches"]
        self._hold()
        full = self.loader.num_max_minibatches
        self.loader.num_max_minibatches = n_batches
        try:
            self.trainer.optimize_model(do_training=True)
        finally:
            self.loader.num_max_minibatches = full
        if not self.capture.full:
            raise RuntimeError(f"set-up ran {len(self.capture.steps)} "
                               "train steps; the check needs 3")
        self.capture = None
        self.feed.reset()
        torch.cuda.synchronize() if self.device.type == "cuda" else None

    # -- the window ----------------------------------------------------------

    def window(self, seconds: float) -> None:
        if self.trace:
            sl = self.cell.traffic["trace_slice"]
            self.slice = tracing.Slice(sl["skip"], sl["warmup"],
                                       sl["active"])
            self.slice.start()
        t0 = time.perf_counter()
        self.epochs, self.losses = 0, []
        self.mark = None
        try:
            while True:
                t_epoch = time.perf_counter()
                self._hold()
                self.losses.append(self.trainer.optimize_model(
                    do_training=True))
                self.epochs += 1
                print(f"epoch {self.epochs}: "
                      f"{time.perf_counter() - t_epoch:.3f} s",
                      file=sys.stderr, flush=True)
                if self.epochs == 1:
                    # the traced slice lies in the first epoch: the spans
                    # and counts that the readers take start after it
                    self.mark = (time.perf_counter(), len(self.feed.build_s),
                                 sum(self.feed.flops.values()))
                # a traced run reads the epochs after the traced one
                if (time.perf_counter() - t0 >= seconds
                        and self.epochs > int(self.trace)):
                    break
        finally:
            self.capture = None
            if self.slice is not None:
                self.slice.stop()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.t_window, self.t_end = t0, time.perf_counter()
        self.window_s = self.t_end - t0

    def end_to_end(self) -> Dict[str, float]:
        return {"train_pairs_per_s": self.feed.train_pairs / self.window_s}

    def attempted(self):
        steps = self.feed.steps[True] + self.feed.steps[False]
        bad = sum(1 for v in self.losses if not np.isfinite(v))
        return steps, bad

    # -- what the per-layer readers read ------------------------------------

    def layer_data(self) -> dict:
        """What the per-layer readers read: the spans and counts of the
        epochs after the first (which holds the profiled slice) when the
        window ran more than one, the traced slice, the kernel bounds."""
        tr = self.slice.result if self.slice is not None else None
        t_mark, n_mark, f_mark = (self.mark if self.epochs > 1
                                  else (self.t_window, 0, 0.0))
        return {
            "batch_build_s.train": list(self.feed.build_s[n_mark:]),
            "flops": sum(self.feed.flops.values()) - f_mark,
            "window_s": self.t_end - t_mark,
            "peak_flops": peaks.FP32_FLOPS,
            "trace": tr,
            "kernel_bounds": {k: float(np.mean(v)) for k, v in
                              self.feed.bounds.items() if v},
        }

    # -- the check ---------------------------------------------------------

    def free(self) -> None:
        """Drop the program's state before the reference runs: what is
        left are the held steps (the first three of set-up and of the
        window's last epoch), made of copies."""
        self.loader = self.trainer = self.network = self.paths = None
        self.feed = self.batches = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_batches(self, cap: Capture, keep_half: bool = False):
        """The reference's terms of the held steps."""
        c, ki = self.corpus, self.key_index
        out = []
        for (same, diff), _ in cap.steps:
            def group(pairs):
                return [(c.token(ki[a]), c.token(ki[b]),
                         c.tok_speaker[ki[a]] == c.tok_speaker[ki[b]])
                        for a, b in pairs]
            keep = None
            if keep_half:
                keep = np.arange(len(same) + len(diff)) % 2 == 0
            out.append(train_step.batch_cells(group(same), group(diff),
                                              self.device, keep=keep))
        return out

    def bad_pairs(self) -> int:
        """Pairs of the held batches that are not train pairs of the
        input with their label."""
        known = {(p[:3], p[3:6], p[6]) for p in self.pairs["train"]}
        bad = 0
        for cap in self.held:
            for (same, diff), _ in cap.steps:
                bad += sum((a, b, "same") not in known for a, b in same)
                bad += sum((a, b, "diff") not in known for a, b in diff)
        return bad

    def program_readings(self, cap: Capture) -> dict:
        """The first gradient as the optimizer holds it: adadelta's
        square_avg after step 1 is rho s0 + (1 - rho) g^2."""
        rho = self.values["optimizer"]["rho"]

        def grad_norm(k):
            s0 = cap.start_state[k][0].double()
            g2 = (cap.state1[k].double() - rho * s0) / (1 - rho)
            return float(torch.sqrt(g2.clamp(min=0).sum()))
        return {"losses": [loss for _, loss in cap.steps],
                "grad_norms": {k: grad_norm(k) for k in cap.state1},
                "update_norms": {k: float((cap.params_n[k]
                                           - cap.start[k]).double().norm())
                                 for k in cap.params_n}}

    def reference_readings(self, cap: Capture, tf32: bool = False,
                           keep_half: bool = False) -> dict:
        ref = self.cell.config.reference
        with numerics.tf32(tf32):
            r = train_step.run_steps(
                lambda p, cells: ref.loss(self.values, p, cells),
                cap.start, self.reference_batches(cap, keep_half),
                self.values["optimizer"], state=cap.start_state)
        return {"losses": r["losses"],
                "grad_norms": {k: float(g.double().norm())
                               for k, g in r["first_grad"].items()},
                "update_norms": {k: float((r["params"][k]
                                           - cap.start[k]).double()
                                          .norm())
                                 for k in r["params"]}}

    def numbers(self, side: dict, ref: dict) -> dict:
        shapes = self.cell.config.reference.shapes(self.values)
        return checks.train_numbers(side, ref, next(iter(shapes)) + "/w")

    def held_numbers(self, side) -> List[dict]:
        """Per held run of steps (set-up's, the window's last epoch's),
        ``side(cap)``'s numbers against the float32 reference's; a run
        that did not hold its three steps compares as infinitely far."""
        out = []
        for cap in self.held:
            if not cap.full:
                print(f"held {len(cap.steps)} of {cap.n} steps",
                      file=sys.stderr, flush=True)
                out.append({k: float("inf") for k in checks.TRAIN_NUMBERS})
                continue
            out.append(self.numbers(side(cap), self.reference_readings(cap)))
        return out

    def check(self) -> dict:
        parts = self.held_numbers(self.program_readings)
        self.check_parts = dict(zip(("setup", "window_end"), parts))
        out = checks.worst(parts)
        out["bad_pairs"] = float(self.bad_pairs())
        return out

    def control_readings(self) -> dict:
        """The control (the reference in TF32) and the faults planted in
        the reference, each against the float32 reference, over the
        held steps; the pairs are the program's (``bad_pairs`` 0)."""
        out = {}
        for name, kw in (("control_tf32", {"tf32": True}),
                         ("fault_half_batch", {"keep_half": True})):
            parts = self.held_numbers(
                lambda cap: self.reference_readings(cap, **kw))
            out[name] = dict(checks.worst(parts), bad_pairs=0.0)
        return out
