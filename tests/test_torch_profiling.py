"""The port's stage tracing (``abnet3_torch.profiling``)."""

import json
import os

import torch

from abnet3_torch.profiling import profiling_enabled, stage_trace


def test_stage_trace_is_a_named_range(monkeypatch):
    monkeypatch.delenv("ABNET3_PROFILE", raising=False)
    assert not profiling_enabled()
    with torch.profiler.profile() as prof:
        with stage_trace("stage-x"):
            torch.ones(4).sum()
    assert "stage-x" in {e.name for e in prof.events()}


def test_stage_trace_captures_each_stage(monkeypatch, tmp_path):
    """With ABNET3_PROFILE=<dir>, each stage writes its own Chrome trace
    under a dated, counter-numbered directory."""
    monkeypatch.setenv("ABNET3_PROFILE", str(tmp_path))
    assert profiling_enabled()
    for _ in range(2):
        with stage_trace("features-spectral"):
            torch.ones(8).cumsum(0)
    dirs = sorted(os.listdir(tmp_path))
    assert len(dirs) == 2 and all(d.startswith("features-spectral-")
                                  for d in dirs)
    assert dirs[0].rsplit("-", 1)[1] != dirs[1].rsplit("-", 1)[1]
    for d in dirs:
        with open(tmp_path / d / "trace.json") as fh:
            trace = json.load(fh)
        assert any(e.get("name") == "features-spectral"
                   for e in trace["traceEvents"])


def test_stage_trace_names_the_rank(monkeypatch, tmp_path):
    """A rank of a process group of several puts ``rank<r>`` in its
    capture directory's name, so ranks do not overwrite each other's
    traces; a lone process does not."""
    import types

    from abnet3_torch import profiling
    monkeypatch.setenv("ABNET3_PROFILE", str(tmp_path))
    for world in (2, 1):
        monkeypatch.setattr(profiling, "dist", types.SimpleNamespace(
            is_available=lambda: True, is_initialized=lambda: True,
            get_world_size=lambda: world, get_rank=lambda: 1))
        with stage_trace("train-epoch-0"):
            torch.ones(4).sum()
    dirs = sorted(os.listdir(tmp_path))
    assert len(dirs) == 2
    assert sum(d.startswith("train-epoch-0-rank1-") for d in dirs) == 1
    assert sum("-rank" not in d for d in dirs) == 1


# -- spans and counters -----------------------------------------------------

import sys
import threading
import types

import numpy as np
import pytest

from abnet3_torch import profiling


@pytest.fixture
def spans_on():
    """Spans on for one test, then back to how they were."""
    was = profiling._on
    profiling.spans_on()
    try:
        yield
    finally:
        if not was:
            profiling.spans_off()


@pytest.fixture
def clock(monkeypatch):
    """The profiling module's clock as a list of readings."""
    readings = []
    it = iter(readings)
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(
        perf_counter=lambda: next(it)))
    return readings


def _since(before):
    return profiling.totals_since(before, profiling.span_totals())


def test_span_off_is_the_shared_no_op(monkeypatch):
    """Off, span() returns one shared context, reads no clock, opens no
    range and keeps nothing; count() keeps nothing either."""
    assert not profiling._on
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(
        perf_counter=lambda: pytest.fail("the clock was read")))
    before = profiling.span_totals()
    assert profiling.span("t/a") is profiling.span("t/b", 3)
    with torch.profiler.profile() as prof:
        with profiling.span("t/a", 3):
            torch.ones(4).sum()
        profiling.count("t/bytes", 8)
        assert list(profiling.waited([1, 2], "t/wait")) == [1, 2]
    names = {e.name for e in prof.events()}
    assert "aten::sum" in names
    assert not names & {"t/a", "t/wait"}
    assert _since(before) == {"spans": {}, "counters": {}}


def test_nested_spans_count_total_and_self_time(spans_on, clock):
    clock += [0.0, 1.0, 3.0, 6.0, 10.0, 10.5]
    before = profiling.span_totals()
    with profiling.span("t/outer"):
        with profiling.span("t/inner", 0):
            pass
    with profiling.span("t/inner", 1):
        pass
    got = _since(before)["spans"]
    assert got["t/outer"] == {"count": 1, "total_s": 6.0, "self_s": 4.0}
    assert got["t/inner"] == {"count": 2, "total_s": 2.5, "self_s": 2.5}


def test_spans_are_ranges_under_the_profiler(spans_on):
    with torch.profiler.profile(record_shapes=True) as prof:
        with profiling.span("t/outer"):
            with profiling.span("t/inner", 7):
                torch.ones(4).sum()
    ev = {e.name: e for e in prof.events()}
    outer, inner = ev["t/outer"].time_range, ev["t/inner"].time_range
    assert outer.start <= inner.start and inner.end <= outer.end
    # the batch index rides as the range's keyword argument
    if hasattr(ev["t/inner"], "kwinputs"):
        assert ev["t/inner"].kwinputs == {"index": 7}


def test_spans_and_counts_from_threads_add_up(spans_on):
    """Threads recording at once (as the prefetch worker and the main
    thread do) lose no span and no count; each thread's self time is
    its own."""
    n_threads, n_each = 8, 400
    before = profiling.span_totals()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_each):
                with profiling.span("t/thread.outer"):
                    with profiling.span("t/thread.inner"):
                        profiling.count("t/thread.bytes", 3)
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    got = _since(before)
    outer, inner = (got["spans"][f"t/thread.{k}"] for k in ("outer",
                                                            "inner"))
    assert outer["count"] == inner["count"] == n_threads * n_each
    assert got["counters"]["t/thread.bytes"] == 3 * n_threads * n_each
    assert outer["self_s"] == pytest.approx(
        outer["total_s"] - inner["total_s"], abs=1e-9)
    assert 0.0 <= outer["self_s"] <= outer["total_s"]


def test_count_adds_up_while_on(spans_on):
    before = profiling.span_totals()
    profiling.count("t/count", 5)
    profiling.count("t/count", 7)
    profiling.spans_off()
    profiling.count("t/count", 100)
    profiling.spans_on()
    assert _since(before)["counters"] == {"t/count": 12}


def test_waited_counts_the_items_not_the_end(spans_on):
    before = profiling.span_totals()
    assert list(profiling.waited(iter("abc"), "t/wait")) == ["a", "b", "c"]
    assert _since(before)["spans"]["t/wait"]["count"] == 3


def test_stage_capture_writes_its_span_totals(monkeypatch, tmp_path):
    """With ABNET3_PROFILE set after the import, a stage turns spans on
    for itself and writes their totals as spans.json beside trace.json;
    spans are off again after it."""
    monkeypatch.setenv("ABNET3_PROFILE", str(tmp_path))
    assert not profiling._on
    def worker():
        with profiling.span("t/worker"):
            torch.ones(4).sum()
    with stage_trace("stage-s"):
        with profiling.span("t/in-stage"):
            torch.ones(4).sum()
        profiling.count("t/stage.bytes", 4)
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=60)
    assert not t.is_alive()
    assert not profiling._on
    (d,) = os.listdir(tmp_path)
    with open(tmp_path / d / "trace.json") as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    # the capture records every thread, as the loaders' prefetch worker
    assert {"stage-s", "t/in-stage", "t/worker"} <= names
    with open(tmp_path / d / "spans.json") as fh:
        totals = json.load(fh)
    assert totals["spans"]["stage-s"]["count"] == 1
    assert totals["spans"]["t/in-stage"]["count"] == 1
    assert totals["spans"]["t/worker"]["count"] == 1
    assert totals["counters"] == {"t/stage.bytes": 4}
    stage, inner = totals["spans"]["stage-s"], totals["spans"]["t/in-stage"]
    assert stage["self_s"] == pytest.approx(
        stage["total_s"] - inner["total_s"], abs=1e-9)


# -- the trainer and its loader ---------------------------------------------

def _corpus():
    """4 files x 80 frames x 4 dims in memory; 6 train and 2 dev pairs."""
    from abnet3_torch.utils import Features_Accessor
    rng = np.random.RandomState(0)
    items = [f"f{i}" for i in range(4)]
    feats = {f: rng.randn(80, 4).astype(np.float32) for f in items}
    times = {f: np.arange(80) * 0.01 + 0.0025 for f in items}
    train = [("f0", 0.0, 0.12, "f1", 0.3, 0.39, "same"),
             ("f1", 0.0, 0.2, "f2", 0.1, 0.25, "same"),
             ("f2", 0.3, 0.5, "f3", 0.0, 0.08, "diff"),
             ("f0", 0.4, 0.55, "f3", 0.2, 0.42, "diff"),
             ("f3", 0.5, 0.62, "f0", 0.6, 0.7, "same"),
             ("f1", 0.5, 0.58, "f2", 0.6, 0.75, "diff")]
    dev = [("f0", 0.1, 0.2, "f2", 0.4, 0.52, "same"),
           ("f1", 0.6, 0.7, "f3", 0.6, 0.72, "diff")]
    return Features_Accessor(times, feats), {"train": train, "dev": dev}


LOADERS = {"bank": dict(align_backend="bank", batch_size=2,
                        num_max_minibatches=3, steps_per_call=2),
           "device": dict(align_backend="device", batch_size=3,
                          num_max_minibatches=2)}


@pytest.mark.parametrize("prefetch", [2, 0])
@pytest.mark.parametrize("backend", list(LOADERS))
def test_trainer_epoch_spans_count_its_steps_and_batches(
        spans_on, tmp_path, backend, prefetch):
    from abnet3_torch.dataloader import OriginalDataLoader
    from abnet3_torch.loss import coscos2
    from abnet3_torch.models.siamese import SiameseNetwork
    from abnet3_torch.trainer import TrainerSiamese
    loader = OriginalDataLoader(None, None, seed=0, device="cpu",
                                **LOADERS[backend])
    loader.features, loader.pairs = _corpus()
    loader.load_data()
    net = SiameseNetwork(input_dim=4, num_hidden_layers=1, hidden_dim=8,
                         output_dim=4, p_dropout=0.0, batch_norm=False,
                         activation_layer="sigmoid", device="cpu")
    trainer = TrainerSiamese(network=net, loss=coscos2(), dataloader=loader,
                             optimizer_type="adadelta", lr=0.1, num_epochs=1,
                             seed=0, device="cpu", cuda=False,
                             log_dir=str(tmp_path), prefetch=prefetch)
    # what train() starts with
    trainer.train_losses, trainer.dev_losses = [], []
    losses, batches = {}, {True: 0, False: 0}
    run_pass, iterate = trainer._pass, loader.batch_iterator

    def counted_pass(train_mode, do_training):
        losses[train_mode] = run_pass(train_mode, do_training)
        return losses[train_mode]

    def counted_batches(train_mode=True):
        for b in iterate(train_mode=train_mode):
            batches[train_mode] += 1
            yield b
    trainer._pass, loader.batch_iterator = counted_pass, counted_batches
    before = profiling.span_totals()
    trainer.optimize_model(do_training=True)
    got = _since(before)
    spans, counters = got["spans"], got["counters"]
    n_train, n_dev = len(losses[True]), len(losses[False])
    assert n_train == batches[True] > 0 and n_dev == batches[False] > 0
    assert spans["train/step"]["count"] == n_train
    assert spans["dev/step"]["count"] == n_dev
    assert spans["train/loader.wait"]["count"] == batches[True]
    assert spans["dev/loader.wait"]["count"] == batches[False]
    assert spans["train/loader.build"]["count"] == batches[True]
    for part in ("forward", "backward", "optimizer"):
        assert spans[f"train/step.{part}"]["count"] == n_train, part
    assert spans["dev/step.forward"]["count"] == n_dev
    step = spans["train/step"]
    assert step["self_s"] < step["total_s"]
    if backend == "bank":
        # the split step's matrix mode: ids uploaded, frames prepared
        for part in ("upload", "prepare"):
            assert spans[f"train/step.{part}"]["count"] == n_train, part
            assert spans[f"dev/step.{part}"]["count"] == n_dev, part
        assert not counters
    else:
        for part in ("align", "walk", "gather"):
            assert spans[f"train/loader.{part}"]["count"] > 0, part
        assert counters["train/h2d_pageable_bytes"] > 0
        assert counters["dev/h2d_pageable_bytes"] > 0


def test_multimodal_epoch_spans_and_gather_counter(spans_on, tmp_path):
    """An epoch of the multimodal frame step: per step and per branch one
    span around each pre-net and one around the unit, named by the
    network's mode, and the bytes the step gathers from the two modality
    tables, counted from the rows."""
    from abnet3_torch.dataloader import MultimodalDataLoader
    from abnet3_torch.integration import BiWeightedDeepLearnt
    from abnet3_torch.loss import coscos2
    from abnet3_torch.models.multimodal import MultimodalSiameseNetwork
    from abnet3_torch.trainer import MultimodalTrainer
    from abnet3_torch.utils import Features_Accessor
    feats, pairs = _corpus()
    wide = Features_Accessor(feats.times, {
        f: np.repeat(v, 2, axis=1)[:, :6] for f, v in feats.features.items()})
    loader = MultimodalDataLoader(None, ["a", "b"], batch_size=8,
                                  max_batches_per_epoch=3, steps_per_call=2,
                                  device="cpu")
    loader.features_dict = {"a": feats, "b": wide}
    loader.pairs = pairs
    loader._rng = np.random.RandomState(0)
    net = MultimodalSiameseNetwork(
        integration_unit=BiWeightedDeepLearnt(net_params=[[8, 1], [8, 1]]),
        pre_integration_net_params=[[4, 8, 8], [6, 8, 8]],
        post_integration_net_params=[8, 4], attention_lr=0.01,
        asynchronous_integration_index=1, activation_layer="sigmoid",
        device="cpu")
    trainer = MultimodalTrainer(network=net, loss=coscos2(),
                                dataloader=loader, optimizer_type="adadelta",
                                lr=0.1, num_epochs=1, seed=0, device="cpu",
                                cuda=False, log_dir=str(tmp_path))
    trainer.train_losses, trainer.dev_losses = [], []
    rows = {True: 0, False: 0}
    run_step = trainer._run_step

    def counted(b, do_training):
        rows[do_training] += len(b.i1)
        return run_step(b, do_training)
    trainer._run_step = counted
    before = profiling.span_totals()
    trainer.optimize_model(do_training=True)
    got = _since(before)
    spans, counters = got["spans"], got["counters"]
    for mode in ("train", "dev"):
        n = spans[f"{mode}/step"]["count"]
        assert n > 0
        for part in ("pre_0", "pre_1", "integration"):
            assert spans[f"{mode}/mm.{part}"]["count"] == 2 * n, (mode, part)
    row_bytes = 2 * (4 + 6) * 4
    assert counters["train/mm_gather_bytes"] == row_bytes * rows[True]
    assert counters["dev/mm_gather_bytes"] == row_bytes * rows[False]


# -- the spans of each step factory -----------------------------------------

class _Draws:
    """A stand-in pair sampler: the same draw (ids1, ids2, y) each call."""

    def __init__(self, draw):
        self.draw = draw

    def sample(self, generator, with_speakers=False):
        return self.draw


def _step_case(case):
    """(train_step, eval_step or None, args) of one step factory at a
    tiny size on the CPU; a sampled case's steps take a generator."""
    from abnet3_torch import parallel
    from abnet3_torch.loss import coscos2, weighted_loss_multi
    from abnet3_torch.models.siamese import (SiameseMultitaskNetwork,
                                             SiameseNetwork)
    from abnet3_torch.ops.bank import TokenBank
    from abnet3_torch.trainer import build_optimizer
    rng = np.random.RandomState(0)
    D = 4
    bank = TokenBank({i: rng.randn(rng.randint(5, 13), D).astype(np.float32)
                      for i in range(12)}, device="cpu")
    multitask = case == "split-matrix-multitask"
    if multitask:
        net = SiameseMultitaskNetwork(
            input_dim=D, num_hidden_layers_shared=1, num_hidden_layers_spk=1,
            num_hidden_layers_phn=1, hidden_dim=8, output_dim=4,
            p_dropout=0.0, activation_layer="sigmoid", device="cpu")
        loss = weighted_loss_multi(loss_spk=coscos2(), loss_phn=coscos2(),
                                   weight=0.5)
    elif case == "frame-table-multimodal":
        from abnet3_torch.integration import BiWeightedDeepLearnt
        from abnet3_torch.models.multimodal import MultimodalSiameseNetwork
        net = MultimodalSiameseNetwork(
            integration_unit=BiWeightedDeepLearnt(net_params=[[8, 1],
                                                              [8, 1]]),
            pre_integration_net_params=[[4, 8, 8], [6, 8, 8]],
            post_integration_net_params=[8, 4],
            asynchronous_integration_index=1, activation_layer="sigmoid",
            device="cpu")
        loss = coscos2()
    else:
        net = SiameseNetwork(input_dim=D, num_hidden_layers=1, hidden_dim=8,
                             output_dim=4, p_dropout=0.0,
                             activation_layer="sigmoid", device="cpu")
        loss = coscos2()
    net.ensure_init(0)
    opt = build_optimizer("adadelta", net.parameters(), 0.1)

    def ids(n):
        return torch.from_numpy(rng.randint(0, len(bank), n).astype(np.int64))

    ones, signs = torch.ones(6), torch.tensor([1.0, -1.0] * 3)
    matrix = "gather" not in case
    if case.startswith("split"):
        steps = parallel.make_split_pair_train_step(
            net, loss, opt, bank, max_frames=16, matrix_loss=matrix,
            extra_labels=multitask)
        args = [ids(6), ids(6), ones, ids(6), ids(6), ones]
        if multitask:
            args += [signs, -signs]
        return steps + (args,)
    if case.startswith("mixed"):
        tcl = case == "mixed-tcl"
        frame_bank = torch.randn(30, D) if tcl else None
        steps = parallel.make_pair_train_step(
            net, loss, opt, bank, max_frames=16, matrix_loss=matrix,
            frame_bank=frame_bank, tcl=0.3 if tcl else 0.0)
        args = [ids(6), ids(6), signs, ones]
        if tcl:
            args += [torch.arange(4), torch.arange(4, 8), torch.ones(4),
                     torch.ones(4)]
        return steps + (args,)
    if case.startswith("frame-table"):
        tables = [torch.randn(30, D)]
        if case == "frame-table-multimodal":
            tables.append(torch.randn(30, 6))
        steps = parallel.make_frame_train_step(
            net, loss, opt, tables, multimodal=len(tables) > 1)
        return steps + ([torch.arange(8), torch.arange(8, 16),
                         torch.tensor([1.0, -1.0] * 4), torch.ones(8)],)
    if case == "frame-pair":
        from abnet3_torch.dataloader import Batch
        steps = parallel.make_frame_pair_steps(net, loss, opt)
        # a whole Batch, its y_spk None (a siamese batch)
        return steps + (list(Batch(torch.randn(8, D), torch.randn(8, D),
                                   torch.tensor([1.0, -1.0] * 4),
                                   torch.ones(8))),)
    if case.startswith("fused"):
        def padded(n):
            return torch.randn(n, 10, D), torch.randint(5, 11, (n,))
        (f1s, n1s), (f2s, n2s) = padded(3), padded(3)
        (f1d, n1d), (f2d, n2d) = padded(3), padded(3)
        step = parallel.make_fused_train_step(net, loss, opt,
                                              matrix_loss=matrix)
        return step, None, [f1s, f2s, n1s, n2s, f1d, f2d, n1d, n2d]
    sampler = _Draws((ids(6), ids(6), signs))
    return (parallel.make_sampled_train_step(net, loss, opt, bank, sampler),
            parallel.make_sampled_eval_step(net, loss, bank, sampler),
            [torch.Generator()])


def _opened(monkeypatch, run):
    """The spans ``run()`` opens, in order, each as the path of the spans
    open at its start (outermost first, joined by ' > ')."""
    paths = []
    enter = profiling._Span.__enter__

    def recorded(self):
        stack = getattr(profiling._local, "stack", None) or []
        paths.append(" > ".join([s.name for s in stack] + [self.name]))
        return enter(self)
    with monkeypatch.context() as m:
        m.setattr(profiling._Span, "__enter__", recorded)
        run()
    return paths


_TRAIN = ["train/step.prepare", "train/step.forward", "train/step.backward",
          "train/step.optimizer"]
_EVAL = ["dev/step.prepare", "dev/step.forward"]


def _modal(mode):
    """A multimodal forward's spans: each side's pre-nets, then its unit."""
    return [f"{mode}/step.forward > {mode}/mm.{part}" for _ in range(2)
            for part in ("pre_0", "pre_1", "integration")]


# the ordered spans of one train step and one eval step of each factory
# (the train step's, the eval step's; a fused step has no eval step)
STEP_SPANS = {
    "split-matrix": (_TRAIN, _EVAL),
    "split-matrix-multitask": (_TRAIN, _EVAL),
    "split-gather": (_TRAIN, _EVAL),
    "mixed-matrix": (_TRAIN, _EVAL),
    "mixed-gather": (_TRAIN, _EVAL),
    "mixed-tcl": (_TRAIN, _EVAL),
    "frame-table": (_TRAIN, _EVAL),
    "frame-table-multimodal": (
        _TRAIN[:2] + _modal("train") + _TRAIN[2:],
        _EVAL + _modal("dev")),
    "frame-pair": (_TRAIN[1:], _EVAL[1:]),
    "fused-matrix": (_TRAIN, None),
    "fused-gather": (_TRAIN, None),
    # the mixed-pair step's: a sampled step prepares (aligns) its draw
    # under the prepare spans, and its eval step opens the forward's too
    "sampled": (_TRAIN, _EVAL),
}


@pytest.mark.parametrize("case", list(STEP_SPANS))
def test_step_spans_in_order(spans_on, monkeypatch, case):
    """One train step and one eval step of each step factory open their
    spans by name, order and nesting as written: the readers of
    ``step_host_ms.train``, ``optimizer_ms.train``, ``premodal_ms.train``
    and ``integration_ms.train`` and the breakdown's gaps read them."""
    train, evaluate, args = _step_case(case)
    want_train, want_eval = STEP_SPANS[case]
    assert _opened(monkeypatch, lambda: train(*args)) == want_train
    if want_eval is not None:
        assert _opened(monkeypatch, lambda: evaluate(*args)) == want_eval
