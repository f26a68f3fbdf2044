"""The CUDA graphs of the split bank step and of the frame-table step
(``parallel.mesh._GraphedSteps``).

On the CPU: which steps the rule lets replay graphs (on the card only,
without a mesh, a tcl group or an optimizer that takes a closure), that
the frame-table step takes them where the rule holds and the frame-pair
step never does, which networks' graphs advance the network's generator,
and the readers of ``graph_replay_share.train`` and
``frame_graph_replay_share.train``. On a card (``-m cuda``, skipped
without one): the flagship's and the multitask network's split step and
the frame-table step (siamese, multimodal with a learned gate,
multimodal with drawn modality masks), graphed against the eager step
from the same parameters and Adadelta state, step by step and through
the trainer. This file imports neither jax nor abnet3_tpu, so it also
runs where they are not installed:

    python -m pytest tests/test_torch_graph_step.py -m cuda --noconftest
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from abnet3_torch import profiling
from abnet3_torch.dataloader import SplitBankBatch
from abnet3_torch.integration import BiWeightedDeepLearnt, MultitaskIntegration
from abnet3_torch.loss import coscos2, weighted_loss_multi
from abnet3_torch.models.multimodal import MultimodalSiameseNetwork
from abnet3_torch.models.siamese import (SiameseMultitaskNetwork,
                                         SiameseNetwork)
from abnet3_torch.ops import cuda_dtw
from abnet3_torch.ops.bank import TokenBank
from abnet3_torch.parallel import mesh as pmesh
from abnet3_torch.trainer import (MultimodalTrainer, TrainerSiamese,
                                  TrainerSiameseMultitask, build_optimizer)

D = 12
BUCKETS = (32, 64, 96)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tokens(seed=0, n=60):
    rng = np.random.RandomState(seed)
    return {i: rng.randn(rng.randint(20, 97), D).astype(np.float32)
            for i in range(n)}


def _network(kind, device, seed=0):
    """A small network of ``kind``: the flagship's family (``siamese``,
    with batch norm and dropout in ``siamese-bn-dropout``, bf16 products
    in ``siamese-bf16``) or the multitask one, initialised from seed."""
    if kind == "multitask":
        net = SiameseMultitaskNetwork(
            input_dim=D, num_hidden_layers_shared=1, num_hidden_layers_spk=1,
            num_hidden_layers_phn=1, hidden_dim=32, output_dim=16,
            p_dropout=0.0, activation_layer="sigmoid", device=device)
    else:
        net = SiameseNetwork(
            input_dim=D, num_hidden_layers=2, hidden_dim=32, output_dim=16,
            p_dropout=0.1 if kind == "siamese-bn-dropout" else 0.0,
            batch_norm=kind == "siamese-bn-dropout",
            activation_layer="sigmoid",
            compute_dtype="bfloat16" if kind == "siamese-bf16"
            else "float32", device=device)
    net.ensure_init(seed)
    return net


def _loss(kind):
    if kind == "multitask":
        return weighted_loss_multi(loss_spk=coscos2(), loss_phn=coscos2(),
                                   weight=0.5)
    return coscos2()


def _host_batch(rng, n_tokens, multitask, Bs=8, Bd=8, bucket=None):
    """A SplitBankBatch of fixed group sizes whose ragged tail weighs 0."""
    ids = rng.randint(0, n_tokens, size=2 * (Bs + Bd)).astype(np.int32)
    ws = np.ones(Bs, np.float32)
    wd = np.ones(Bd, np.float32)
    ws[-1] = wd[-2:] = 0.0
    spk = {}
    if multitask:
        spk = dict(y_spk_s=rng.choice([-1.0, 1.0], Bs).astype(np.float32),
                   y_spk_d=rng.choice([-1.0, 1.0], Bd).astype(np.float32))
    return SplitBankBatch(ids[:Bs], ids[Bs:2 * Bs], ws,
                          ids[2 * Bs:2 * Bs + Bd], ids[2 * Bs + Bd:], wd,
                          bucket=bucket, **spk)


def _step_args(b, device):
    args = [b.ids1s, b.ids2s, b.ws, b.ids1d, b.ids2d, b.wd]
    if b.y_spk_s is not None:
        args += [b.y_spk_s, b.y_spk_d]
    return [torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu"
                             else a).to(device) for a in args]


def _code(fn):
    return fn.__code__


# the second modality's width (the frame-table networks' first is D)
D_B = 9


def _frame_network(kind, device, seed=0):
    """A small network of a frame-table step: ``siamese`` or
    ``siamese-bn-dropout`` (see :func:`_network`) on one table, or a
    multimodal one on two (two-layer pre-nets, a unit, a post-net, batch
    norm): ``multimodal`` with the benchmark's kind of gate, a
    ``BiWeightedDeepLearnt`` reading the pre-nets' layer 1 in its own
    parameter group (``attention_lr``), ``multimodal-masks`` with a
    ``MultitaskIntegration`` unit, which draws modality masks from the
    network's generator."""
    if kind.startswith("siamese"):
        return _network(kind, device, seed)
    if kind == "multimodal":
        unit = BiWeightedDeepLearnt(net_params=[[16, 1], [16, 1]],
                                    integration_mode="sum")
        post, index, attention_lr = [16, 8], 1, 0.01
    else:
        unit = MultitaskIntegration(
            representation_modes=[(1, 0), (0, 1), (1, 1)],
            feed_modes="many2many", dimensions_list=[16, 16])
        post, index, attention_lr = [32, 8], None, None
    net = MultimodalSiameseNetwork(
        integration_unit=unit,
        pre_integration_net_params=[[D, 16, 16], [D_B, 16, 16]],
        post_integration_net_params=post, attention_lr=attention_lr,
        asynchronous_integration_index=index, p_dropout=0.0,
        batch_norm=True, activation_layer="sigmoid", device=device)
    net.ensure_init(seed)
    return net


def _frame_optimizer(net):
    """Adadelta at lr 0.1 as the multimodal trainer builds it: with an
    ``attention_lr`` the main network and the unit are two groups."""
    lr = getattr(net, "attention_lr", None)
    if not lr:
        return build_optimizer("adadelta", net.parameters(), 0.1)
    unit = list(net.integration_unit.parameters())
    ids = {id(p) for p in unit}
    main = [p for p in net.parameters() if id(p) not in ids]
    return build_optimizer("adadelta", [{"params": main},
                                        {"params": unit, "lr": lr}], 0.1)


def _frame_tables(kind, device, n=300):
    g = torch.Generator().manual_seed(17)
    dims = (D,) if kind.startswith("siamese") else (D, D_B)
    return tuple(torch.randn(n, d, generator=g).to(device) for d in dims)


def _frame_args(rng, n_table, rows, device, tail=0):
    """(i1, i2, y, w) of a frame-table batch whose last ``tail`` rows are
    padding: index 0, weight 0 (the loader's ragged tail)."""
    i1, i2 = rng.randint(0, n_table, size=(2, rows))
    y = rng.choice([-1.0, 1.0], rows).astype(np.float32)
    w = np.ones(rows, np.float32)
    if tail:
        i1[-tail:] = i2[-tail:] = 0
        w[-tail:] = 0.0
    return [torch.from_numpy(a).to(device)
            for a in (i1.astype(np.int64), i2.astype(np.int64), y, w)]


# -- the CPU: the rule and the untouched steps -----------------------------

class _Closure:
    takes_closure = True


@pytest.mark.parametrize("device,mesh,optimizer,frame_bank,graphed", [
    ("cuda", None, object(), None, True),
    ("cuda:0", None, None, None, True),
    ("cpu", None, object(), None, False),
    ("cuda", object(), object(), None, False),
    ("cuda", None, _Closure(), None, False),
    ("cuda", None, object(), object(), False)],
    ids=["card", "card-eval-only", "cpu", "mesh", "lbfgs", "tcl"])
def test_graph_rule(device, mesh, optimizer, frame_bank, graphed):
    assert pmesh._graphable(torch.device(device), mesh, optimizer,
                            frame_bank) is graphed


@pytest.fixture
def eager_code():
    """The code of the one step body's eager (train_step, eval_step)."""
    body = pmesh._StepBody(None, None, lambda parts: None)
    return _code(body.train_step), _code(body.eval_step)


@pytest.mark.parametrize("kind", ["siamese", "multitask"])
@pytest.mark.parametrize("case", ["cpu", "lbfgs", "mesh"])
def test_split_step_stays_eager(kind, case, eager_code):
    """On the CPU, with LBFGS and under a mesh the factory gives the
    eager steps, whose losses do not depend on the rule."""
    import contextlib
    net = _network(kind, "cpu")
    opt = build_optimizer("LBFGS" if case == "lbfgs" else "adadelta",
                          net.parameters(), 0.1)
    bank = TokenBank(_tokens(), device="cpu")
    batch = _host_batch(np.random.RandomState(1), len(bank),
                        kind == "multitask")
    if case == "mesh":
        from torch_parity import cpu_mesh_1x1
        ctx = cpu_mesh_1x1()
    else:
        ctx = contextlib.nullcontext()
    with ctx as mesh:
        train, evaluate = pmesh.make_split_pair_train_step(
            net, _loss(kind), opt, bank, max_frames=32,
            extra_labels=kind == "multitask", mesh=mesh)
        if mesh is None:
            assert (_code(train), _code(evaluate)) == eager_code
        v = evaluate(*_step_args(batch, "cpu"))
    assert torch.isfinite(v)
    assert not isinstance(getattr(train, "__self__", None),
                          pmesh._GraphedSteps)


class _FrameLoader:
    """The frame-table loader's surface that ``_steps_for`` reads."""

    def __init__(self, table):
        self.table = table

    def frame_tables(self, train):
        return [self.table]


def test_frame_steps_are_the_eager_ones(tmp_path, eager_code):
    """On the CPU, where the graph rule does not hold,
    ``make_frame_train_step`` and the trainer's ``_frame_pair_step`` get
    the step body's eager functions."""
    from abnet3_torch.dataloader import Batch, FrameBankBatch
    net = _network("siamese", "cpu")
    trainer = TrainerSiamese(network=net, loss=coscos2(),
                             dataloader=_FrameLoader(torch.randn(40, D)),
                             optimizer_type="adadelta", lr=0.1,
                             device="cpu", log_dir=str(tmp_path))
    fb = FrameBankBatch(np.arange(8), np.arange(8, 16),
                        np.ones(8, np.float32), np.ones(8, np.float32),
                        mode="train")
    train, evaluate = trainer._steps_for(fb)
    assert (_code(train), _code(evaluate)) == eager_code
    x = np.random.RandomState(0).randn(6, D).astype(np.float32)
    trainer._frame_pair_step(Batch(torch.from_numpy(x),
                                   torch.from_numpy(x[::-1].copy()),
                                   torch.ones(6), torch.ones(6)), True)
    assert tuple(map(_code, trainer._step_fns["frames"])) == eager_code


@pytest.fixture
def stub_graphs(monkeypatch):
    """``_GraphedSteps`` replaced by a stand-in that runs the body's
    eager steps and records each call (the CPU captures no graph); the
    list of the stand-ins made."""
    made = []

    class Stub:
        def __init__(self, body):
            self.body, self.calls = body, []
            made.append(self)

        @property
        def steps(self):
            return self.train_step, self.eval_step

        def train_step(self, *args):
            self.calls.append("train")
            return self.body.train_step(*args)

        def eval_step(self, *args):
            self.calls.append("eval")
            return self.body.eval_step(*args)
    monkeypatch.setattr(pmesh, "_GraphedSteps", Stub)
    return made


@pytest.mark.parametrize("graphable", [True, False],
                         ids=["rule-holds", "rule-fails"])
@pytest.mark.parametrize("kind", ["siamese", "multimodal"])
def test_frame_train_step_follows_the_rule(kind, graphable, stub_graphs,
                                           monkeypatch, eager_code):
    """``make_frame_train_step`` asks the rule with its tables' device,
    mesh and optimizer and no tcl group, and wraps its body in
    ``_GraphedSteps`` exactly where the rule holds; a multimodal step
    counts the bytes it gathers on every call, outside the graph."""
    asked = []
    monkeypatch.setattr(pmesh, "_graphable",
                        lambda *a: asked.append(a) or graphable)
    multimodal = kind == "multimodal"
    net = _frame_network(kind, "cpu")
    opt = _frame_optimizer(net)
    tables = _frame_tables(kind, "cpu")
    train, evaluate = pmesh.make_frame_train_step(
        net, coscos2(), opt, tables, multimodal=multimodal)
    assert asked == [(tables[0].device, None, opt, None)]
    assert len(stub_graphs) == int(graphable)
    if graphable:
        assert stub_graphs[0].body.network is net
    if not multimodal:
        assert (_code(train), _code(evaluate)) == (
            (_code(stub_graphs[0].train_step), _code(stub_graphs[0].eval_step))
            if graphable else eager_code)
    rng = np.random.RandomState(4)
    profiling.spans_on()
    before = profiling.span_totals()
    try:
        for training in (True, False, True):
            v = (train if training else evaluate)(
                *_frame_args(rng, len(tables[0]), 32, "cpu", tail=5))
            assert torch.isfinite(v)
        counters = profiling.totals_since(
            before, profiling.span_totals())["counters"]
    finally:
        profiling.spans_off()
    if graphable:
        assert stub_graphs[0].calls == ["train", "eval", "train"]
    row = 2 * sum(t.shape[1] * t.element_size() for t in tables)
    want = ({"train/mm_gather_bytes": 2 * 32 * row,
             "dev/mm_gather_bytes": 32 * row} if multimodal else {})
    assert {k: v for k, v in counters.items()
            if k.endswith("mm_gather_bytes")} == want


def test_frame_pair_steps_are_never_graphed(monkeypatch, eager_code):
    """The frame-pair step (aligned batches whose row count varies) stays
    eager even where the rule holds."""
    def refused(body):
        raise AssertionError("the frame-pair step took a graph")
    monkeypatch.setattr(pmesh, "_graphable", lambda *a: True)
    monkeypatch.setattr(pmesh, "_GraphedSteps", refused)
    net = _network("siamese", "cpu")
    steps = pmesh.make_frame_pair_steps(
        net, coscos2(), build_optimizer("adadelta", net.parameters(), 0.1))
    assert tuple(map(_code, steps)) == eager_code


@pytest.mark.parametrize("kind,draws", [
    ("siamese", False), ("siamese-bn-dropout", True), ("multimodal", False),
    ("multimodal-masks", True)])
def test_graphs_advance_the_generator_of_networks_that_draw(kind, draws):
    """A train graph registers the network's generator where a train
    step draws from it: dropout masks, or a ``MultitaskIntegration``
    unit's modality masks."""
    assert pmesh._draws_masks(_frame_network(kind, "cpu")) is draws


def _reader(name="graph_replay_share.train"):
    path = os.path.join(REPO, "h100_bench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _span_data(steps, replays, dev_steps=None, dev_replays=None):
    spans, counters = {}, {}
    for mode, n, r in (("train", steps, replays),
                       ("dev", dev_steps, dev_replays)):
        if n is not None:
            spans[f"{mode}/step"] = {"count": n, "total_s": 1.0,
                                     "self_s": 0.1}
        if r is not None:
            counters[f"{mode}/graph_replays"] = r
    return {"spans": {"spans": spans, "counters": counters}}


@pytest.mark.parametrize("steps,replays,share", [
    (2000, 2000, 1.0), (1000, 990, 0.99), (64, 0, 0.0), (64, None, None),
    (None, 10, None), (0, 0, None)])
def test_graph_replay_share_reader(steps, replays, share):
    assert _reader()(_span_data(steps, replays)) == share


def test_graph_replay_share_reader_without_spans():
    """An untraced run, or a program without the spans, reads None."""
    assert _reader()({}) is None
    assert _reader()({"spans": None}) is None


# train steps and replays as in test_graph_replay_share_reader (a counter
# that did not move is left out of the totals: no replay), then the dev
# pass alone and beside the train pass
@pytest.mark.parametrize("steps,replays,dev_steps,dev_replays,share", [
    (2000, 2000, None, None, 1.0), (1000, 990, None, None, 0.99),
    (64, 0, None, None, 0.0), (64, None, None, None, 0.0),
    (None, 10, None, None, None), (0, 0, None, None, None),
    (None, None, 2116, 2116, 1.0), (1000, 1000, 2116, 2116, 1.0),
    (1000, 1000, 1000, None, 0.5)])
def test_frame_graph_replay_share_reader(steps, replays, dev_steps,
                                         dev_replays, share):
    read = _reader("frame_graph_replay_share.train")
    assert read(_span_data(steps, replays, dev_steps, dev_replays)) == share


def test_frame_graph_replay_share_reader_without_spans():
    """An untraced run, or a program without the spans, reads None."""
    read = _reader("frame_graph_replay_share.train")
    assert read({}) is None
    assert read({"spans": None}) is None


# -- the card: graphed against eager ---------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


class _Recorder:
    """Wraps ``optimizer.step`` as the benchmark's harness does (the
    attribute on the instance): counts the calls and keeps each call's
    ``.grad`` of every parameter."""

    def __init__(self, optimizer):
        self.calls, self.grads = 0, []
        step = optimizer.step
        params = [p for g in optimizer.param_groups for p in g["params"]]

        def stepped(*a, **kw):
            self.calls += 1
            self.grads.append([None if p.grad is None else p.grad.clone()
                               for p in params])
            return step(*a, **kw)
        optimizer.step = stepped


def _counters(before):
    after = profiling.totals_since(before, profiling.span_totals())
    return {k: after["counters"].get(k, 0) for k in (
        "train/graph_captures", "dev/graph_captures",
        "train/graph_replays", "dev/graph_replays")}


# (bucket, train?, same-group size): a graphed bucket between eager ones,
# train and eval of one bucket in turns, and a batch of new shapes
ORDER = [(32, True, 8), (32, True, 8), (64, True, 8), (32, True, 8),
         (32, False, 8), (96, True, 8), (64, True, 8), (32, False, 8),
         (64, True, 8), (32, False, 8), (96, True, 8), (96, True, 8),
         (64, False, 8), (32, True, 4), (64, False, 8), (96, False, 8),
         (32, True, 4), (32, True, 8), (32, True, 4), (96, False, 8),
         (64, True, 8)]


def _expected_counts():
    seen = {}
    for key in ORDER:
        seen[key] = seen.get(key, 0) + 1
    out = {}
    for mode, training in (("train", True), ("dev", False)):
        n = [c for k, c in seen.items() if k[1] == training]
        out[f"{mode}/graph_captures"] = sum(c >= 2 for c in n)
        out[f"{mode}/graph_replays"] = sum(c - 1 for c in n)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["siamese", "multitask",
                                  "siamese-bn-dropout", "siamese-bf16"])
def test_graphed_split_step_matches_eager(cuda_device, kind, monkeypatch):
    multitask = kind == "multitask"
    bank = TokenBank(_tokens(), device=cuda_device)
    nets = {m: _network(kind, cuda_device) for m in ("graph", "eager")}
    opts = {m: build_optimizer("adadelta", nets[m].parameters(), 0.1)
            for m in nets}
    recorders = {m: _Recorder(opts[m]) for m in nets}

    def steps(mode):
        return {b: pmesh.make_split_pair_train_step(
            nets[mode], _loss(kind), opts[mode], bank, max_frames=b,
            extra_labels=multitask) for b in BUCKETS}
    graphed = steps("graph")
    assert all(isinstance(s[0].__self__, pmesh._GraphedSteps)
               for s in graphed.values())
    with monkeypatch.context() as m:
        m.setattr(pmesh, "_graphable", lambda *a: False)
        eager = steps("eager")

    rng = np.random.RandomState(3)
    batches = [_step_args(_host_batch(rng, len(bank), multitask, Bs=bs),
                          cuda_device) for _, _, bs in ORDER]
    launches = cuda_dtw.dtw_path_cuda.launches
    profiling.spans_on()
    before = profiling.span_totals()
    try:
        losses = {"graph": [], "eager": []}
        for (bucket, training, _), args in zip(ORDER, batches):
            for mode, fns in (("graph", graphed), ("eager", eager)):
                out = fns[bucket][0 if training else 1](*args)
                losses[mode].append(out)
        counters = _counters(before)
    finally:
        profiling.spans_off()
    # every step launched the path kernel once, and counted it
    assert cuda_dtw.dtw_path_cuda.launches - launches == 2 * len(ORDER)
    assert counters == _expected_counts()

    got = [float(v) for v in losses["graph"]]
    want = [float(v) for v in losses["eager"]]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert len(set(got)) == len(got), "a loss repeats an earlier step's"

    n_train = sum(training for _, training, _ in ORDER)
    assert recorders["graph"].calls == recorders["eager"].calls == n_train
    for g_step, e_step in zip(recorders["graph"].grads,
                              recorders["eager"].grads):
        for g, e in zip(g_step, e_step):
            assert g is not None and e is not None
            torch.testing.assert_close(g, e, rtol=1e-5, atol=1e-6)
    for (name, p), (_, q) in zip(nets["graph"].named_parameters(),
                                 nets["eager"].named_parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=1e-6, msg=name)
    for (name, b), (_, c) in zip(nets["graph"].named_buffers(),
                                 nets["eager"].named_buffers()):
        torch.testing.assert_close(b, c, rtol=1e-5, atol=1e-6, msg=name)


class _BankLoader:
    """The split bank backend's surface that the trainer reads: fixed
    batches a split over a device TokenBank, K = 8 steps a call."""

    steps_per_call = 8
    align_different_words = False
    tcl = 0.0
    frame_bank = None
    statistics_training = {}

    def __init__(self, bank, batches):
        self.token_bank = bank
        self.batches = batches

    def batch_iterator(self, train_mode=True):
        return iter(self.batches[train_mode])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["siamese", "multitask"])
def test_graphed_trainer_matches_eager(cuda_device, kind, tmp_path,
                                       monkeypatch):
    """Two epochs through the trainer (buffers of 8 a bucket, partial
    buffers flushed at each pass's end, the prefetch worker on): the
    same per-batch losses and parameters, one optimizer step a train
    step, and every train step of the second epoch a replay."""
    multitask = kind == "multitask"
    bank = TokenBank(_tokens(), device=cuda_device)
    rng = np.random.RandomState(5)

    def split(n_per_bucket):
        out = [_host_batch(rng, len(bank), multitask, bucket=b)
               for b, n in zip(BUCKETS, n_per_bucket) for _ in range(n)]
        return [out[i] for i in rng.permutation(len(out))]
    batches = {True: split((11, 6, 3)), False: split((5, 3, 2))}
    cls = TrainerSiameseMultitask if multitask else TrainerSiamese

    def run(name):
        trainer = cls(network=_network(kind, cuda_device),
                      loss=_loss(kind),
                      dataloader=_BankLoader(bank, batches),
                      optimizer_type="adadelta", lr=0.1, seed=0,
                      device=cuda_device, log_dir=str(tmp_path / name))
        # what train() starts with before its epochs
        trainer.train_losses, trainer.dev_losses = [], []
        recorder = _Recorder(trainer.optimizer)
        run_step = trainer._run_step
        losses = []

        def counted(batch, do_training):
            out = run_step(batch, do_training)
            losses[-1].append(float(out))
            return out
        trainer._run_step = counted
        losses.append([])
        trainer.optimize_model(do_training=True)
        losses.append([])
        profiling.spans_on()
        before = profiling.span_totals()
        try:
            trainer.optimize_model(do_training=True)
            counters = _counters(before)
        finally:
            profiling.spans_off()
        return trainer, recorder, losses, counters

    g_trainer, g_rec, g_losses, g_counters = run("graph")
    with monkeypatch.context() as m:
        m.setattr(pmesh, "_graphable", lambda *a: False)
        e_trainer, e_rec, e_losses, e_counters = run("eager")

    n_train = len(batches[True])
    assert g_rec.calls == e_rec.calls == 2 * n_train
    n_steps = len(batches[True]) + len(batches[False])
    assert [len(epoch) for epoch in g_losses] == [n_steps, n_steps]
    np.testing.assert_allclose(g_losses, e_losses, rtol=1e-5)
    # the epochs run the same batches: each one's steps differ
    for epoch in g_losses:
        assert len(set(epoch)) == len(epoch)
    np.testing.assert_allclose(g_trainer.train_losses,
                               e_trainer.train_losses, rtol=1e-5)
    np.testing.assert_allclose(g_trainer.dev_losses, e_trainer.dev_losses,
                               rtol=1e-5)
    for p, q in zip(g_trainer.network.parameters(),
                    e_trainer.network.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=1e-6)
    assert g_counters == {"train/graph_captures": 0,
                          "dev/graph_captures": 0,
                          "train/graph_replays": n_train,
                          "dev/graph_replays": len(batches[False])}
    assert not any(e_counters.values())


def _frame_counts(order):
    """The graph counters of one ``_GraphedSteps`` over steps of one
    shape a kind: each kind's first step eager, its second captured, and
    every step after the first a replay."""
    out = {}
    for mode, training in (("train", True), ("dev", False)):
        n = sum(t == training for t, _ in order)
        out[f"{mode}/graph_captures"] = int(n >= 2)
        out[f"{mode}/graph_replays"] = max(n - 1, 0)
    return out


def _assert_same_state(opt_a, opt_b):
    """Bit for bit the same optimizer state, parameter by parameter."""
    params_a = [p for g in opt_a.param_groups for p in g["params"]]
    params_b = [p for g in opt_b.param_groups for p in g["params"]]
    assert len(params_a) == len(params_b)
    for p, q in zip(params_a, params_b):
        sa, sb = opt_a.state.get(p, {}), opt_b.state.get(q, {})
        assert set(sa) == set(sb)
        for k in sa:
            assert torch.equal(torch.as_tensor(sa[k]),
                               torch.as_tensor(sb[k])), k


# (train?, padded tail rows): train and eval steps of one table in
# turns, each kind with a padded tail batch among them
FRAME_ORDER = [(True, 0), (True, 0), (False, 0), (True, 0), (False, 0),
               (False, 0), (True, 11), (True, 0), (False, 11), (True, 0),
               (False, 0), (True, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["siamese", "siamese-bn-dropout",
                                  "multimodal", "multimodal-masks"])
def test_graphed_frame_step_matches_eager(cuda_device, kind, monkeypatch):
    """The frame-table step graphed and eager, from the same parameters
    and Adadelta state (two groups for the gate), on the same batches of
    64 rows: bit for bit the same losses, gradients at every optimizer
    step, parameters, buffers, optimizer state and gathered bytes; one
    capture and the replays a step kind."""
    multimodal = kind.startswith("multimodal")
    tables = _frame_tables(kind, cuda_device)
    nets = {m: _frame_network(kind, cuda_device) for m in ("graph", "eager")}
    opts = {m: _frame_optimizer(nets[m]) for m in nets}
    recorders = {m: _Recorder(opts[m]) for m in nets}

    def steps(mode):
        return pmesh.make_frame_train_step(nets[mode], coscos2(), opts[mode],
                                           tables, multimodal=multimodal)
    graphed = steps("graph")
    with monkeypatch.context() as m:
        m.setattr(pmesh, "_graphable", lambda *a: False)
        eager = steps("eager")

    rng = np.random.RandomState(6)
    batches = [_frame_args(rng, len(tables[0]), 64, cuda_device, tail)
               for _, tail in FRAME_ORDER]
    losses, counters = {}, {}
    for mode, fns in (("graph", graphed), ("eager", eager)):
        profiling.spans_on()
        before = profiling.span_totals()
        try:
            losses[mode] = torch.stack([
                fns[0 if training else 1](*args)
                for (training, _), args in zip(FRAME_ORDER, batches)])
            counters[mode] = profiling.totals_since(
                before, profiling.span_totals())["counters"]
        finally:
            profiling.spans_off()

    assert torch.equal(losses["graph"], losses["eager"])
    got = losses["graph"].tolist()
    assert len(set(got)) == len(got), "a loss repeats an earlier step's"
    graph_keys = set(_frame_counts(FRAME_ORDER))
    assert {k: counters["graph"].get(k, 0) for k in graph_keys} == \
        _frame_counts(FRAME_ORDER)
    assert not graph_keys & set(counters["eager"])
    gathered = {k: v for k, v in counters["graph"].items()
                if k.endswith("mm_gather_bytes")}
    assert gathered == {k: v for k, v in counters["eager"].items()
                        if k.endswith("mm_gather_bytes")}
    assert len(gathered) == (2 if multimodal else 0)

    n_train = sum(training for training, _ in FRAME_ORDER)
    assert recorders["graph"].calls == recorders["eager"].calls == n_train
    for g_step, e_step in zip(recorders["graph"].grads,
                              recorders["eager"].grads):
        for g, e in zip(g_step, e_step):
            assert g is not None and torch.equal(g, e)
    for (name, p), (_, q) in zip(nets["graph"].named_parameters(),
                                 nets["eager"].named_parameters()):
        assert torch.equal(p, q), name
    for (name, b), (_, c) in zip(nets["graph"].named_buffers(),
                                 nets["eager"].named_buffers()):
        assert torch.equal(b, c), name
    _assert_same_state(opts["graph"], opts["eager"])


def _multimodal_loader(device):
    """A MultimodalDataLoader on the device backend over in-memory
    features of two modalities (D and D_B dims, four files of 200
    frames): 60 word pairs of 5-40 frames, 45 of them train, batches of
    64 aligned frame pairs, the same batches for the same seed."""
    from abnet3_torch.dataloader import MultimodalDataLoader
    from abnet3_torch.utils import Features_Accessor
    g = torch.Generator().manual_seed(18)
    times = {f"f{i}": np.arange(200) * 0.01 + 0.0025 for i in range(4)}
    dl = MultimodalDataLoader(None, ["a", "b"], batch_size=64,
                              device=device)
    dl.features_dict = {m: Features_Accessor(times, {
        k: torch.randn(200, d, generator=g).numpy() for k in times})
        for m, d in (("a", D), ("b", D_B))}
    rng = np.random.RandomState(19)
    pairs = []
    for k in range(60):
        f1, f2 = rng.randint(4, size=2)
        s1, s2 = rng.randint(0, 150, size=2) * 0.01
        n1, n2 = rng.randint(5, 40, size=2) * 0.01
        pairs.append((f"f{f1}", s1, s1 + n1, f"f{f2}", s2, s2 + n2,
                      "same" if k % 3 else "diff"))
    dl.pairs = {"train": pairs[:45], "dev": pairs[45:]}
    dl._rng = np.random.RandomState(0)
    return dl


@pytest.mark.cuda
@pytest.mark.parametrize("parallel_after", [True, False],
                         ids=["gate-starts", "main-frozen"])
def test_graphed_multimodal_trainer_matches_eager(cuda_device, tmp_path,
                                                  parallel_after,
                                                  monkeypatch):
    """MultimodalTrainer over device frame tables (adadelta, the gate's
    group at ``attention_lr``) with a headstart that ends at the third
    pass: the gate, held at 0.5 until then, starts learning and, unless
    ``parallel_after``, the main network leaves the optimizer. The
    trainer drops its steps there, so the graphs are captured again for
    the new groups. Graphed against eager over an eval pass and three
    train passes: bit for bit the same per-batch losses, pass losses and
    parameters; the third pass captures one graph a split again, and in
    the fourth every step replays."""
    def run(name):
        trainer = MultimodalTrainer(
            headstart=(2, parallel_after, 0.5),
            network=_frame_network("multimodal", cuda_device),
            loss=coscos2(), dataloader=_multimodal_loader(cuda_device),
            optimizer_type="adadelta", lr=0.1, seed=0, device=cuda_device,
            log_dir=str(tmp_path / name))
        # what train() starts with before its epochs
        trainer.train_losses, trainer.dev_losses = [], []
        run_step = trainer._run_step
        losses, counters = [], []

        def counted(batch, do_training):
            out = run_step(batch, do_training)
            losses[-1].append((do_training, float(out)))
            return out
        trainer._run_step = counted
        for do_training in (False, True, True, True):
            losses.append([])
            profiling.spans_on()
            before = profiling.span_totals()
            try:
                trainer.optimize_model(do_training=do_training)
                counters.append(_counters(before))
            finally:
                profiling.spans_off()
        return trainer, losses, counters

    g_trainer, g_losses, g_counters = run("graph")
    with monkeypatch.context() as m:
        m.setattr(pmesh, "_graphable", lambda *a: False)
        e_trainer, e_losses, e_counters = run("eager")

    assert g_losses == e_losses
    assert g_trainer.train_losses == e_trainer.train_losses
    assert g_trainer.dev_losses == e_trainer.dev_losses
    assert g_trainer._frozen_main is not parallel_after
    for (name, p), (_, q) in zip(g_trainer.network.named_parameters(),
                                 e_trainer.network.named_parameters()):
        assert torch.equal(p, q), name
    # the gate learnt from the third pass on; a frozen main network held
    gate_moved = [not torch.equal(p, q) for p, q in zip(
        g_trainer.network.integration_unit.parameters(),
        _frame_network("multimodal", cuda_device).integration_unit
        .parameters())]
    assert all(gate_moved)
    n_train = sum(t for t, _ in g_losses[3])
    n_dev = len(g_losses[3]) - n_train
    assert n_train >= 3 and n_dev >= 3
    assert g_counters[2]["train/graph_captures"] == 1
    assert g_counters[2]["dev/graph_captures"] == 1
    assert g_counters[3] == {"train/graph_captures": 0,
                             "dev/graph_captures": 0,
                             "train/graph_replays": n_train,
                             "dev/graph_replays": n_dev}
    assert not any(v for c in e_counters for v in c.values())
