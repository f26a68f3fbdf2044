"""The split bank step's CUDA graphs (``parallel.mesh._GraphedSteps``).

On the CPU: which steps the rule lets replay graphs (on the card only,
without a mesh, a tcl group or an optimizer that takes a closure), that
the frame-table and frame-pair steps are the eager ones, and the reader
of ``graph_replay_share.train``. On a card (``-m cuda``, skipped without
one): the flagship's and the multitask network's split step, graphed
against the eager step from the same parameters and Adadelta state, step
by step and through the trainer. This file imports neither jax nor
abnet3_tpu, so it also runs where they are not installed:

    python -m pytest tests/test_torch_graph_step.py -m cuda --noconftest
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from abnet3_torch import profiling
from abnet3_torch.dataloader import SplitBankBatch
from abnet3_torch.loss import coscos2, weighted_loss_multi
from abnet3_torch.models.siamese import (SiameseMultitaskNetwork,
                                         SiameseNetwork)
from abnet3_torch.ops import cuda_dtw
from abnet3_torch.ops.bank import TokenBank
from abnet3_torch.parallel import mesh as pmesh
from abnet3_torch.trainer import (TrainerSiamese, TrainerSiameseMultitask,
                                  build_optimizer)

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
    """``make_frame_train_step`` and the trainer's ``_frame_pair_step``
    get the step body's eager functions."""
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


def _reader():
    path = os.path.join(REPO, "h100_bench", "metrics",
                        "graph_replay_share.train.py")
    spec = importlib.util.spec_from_file_location("graph_replay_share", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _span_data(steps, replays):
    spans = {} if steps is None else {"train/step": {
        "count": steps, "total_s": 1.0, "self_s": 0.1}}
    counters = {} if replays is None else {"train/graph_replays": replays}
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
