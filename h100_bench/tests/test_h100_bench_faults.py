"""A whole run of a cell on the CPU (tiny sizes, the program's plain
versions), sound and with the timed path broken underneath: ``correct``
is true for the sound run and false for each fault the cell can have.
The control (the reference in TF32) fails a limit of each cell, and a
fault that only the window's steps have is caught."""

import numpy as np
import pytest
import torch

from h100_bench.tests.tiny import run_tiny, tiny_cell

TRAIN = "siamese-buckeye.bank-train"
GATHER = "siamese-buckeye.gather-train"
EVAL = "siamese-buckeye.abx-eval"


# The CPU's plain frame-pair path rounds the output layer's gradient
# otherwise than the card does (worst leaf 1e-5 here, at most 1.1e-7 over
# the card runs that set the gather cell's limit): that number is the
# card's to hold.
CPU_ONLY_SKIPS = {GATHER: {"grad_gap"}}


@pytest.mark.parametrize("name", [TRAIN, "multitask-buckeye.bank-train",
                                  GATHER, EVAL])
def test_sound_run_is_correct(name):
    res = run_tiny(tiny_cell(name))
    over = {k: e for k, e in res["checks"].items()
            if not e["value"] <= e["limit"]
            and k not in CPU_ONLY_SKIPS.get(name, ())}
    assert not over, over


def test_host_backend_cell_needs_only_data():
    """A cell on the loader's host backend is the gather mix with other
    loader arguments and another builder of its frame batches: data, no
    code."""
    cell = tiny_cell(GATHER)
    cell.traffic["loader"]["align_backend"] = "host"
    cell.traffic["batches"] = {"kind": "frames",
                               "builder": "load_frames_from_pairs"}
    res = run_tiny(cell)
    over = {k: e for k, e in res["checks"].items()
            if not e["value"] <= e["limit"]
            and k not in CPU_ONLY_SKIPS[GATHER]}
    assert not over, over
    assert res["attempted"] > 0 and res["failed"] == 0


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adadelta, "step",
                        lambda self, closure=None: None)


def _half_batch(monkeypatch):
    from abnet3_torch import parallel
    make = parallel.make_split_pair_train_step

    def faulty(*a, **kw):
        train, evaluate = make(*a, **kw)

        def half(*args):
            args = list(args)
            for k in (2, 5):            # ws, wd: weigh half the pairs 0
                w = args[k].clone()
                w[1::2] = 0
                args[k] = w
            return train(*args)
        return half, evaluate
    monkeypatch.setattr(parallel, "make_split_pair_train_step", faulty)


def _wrong_token(monkeypatch):
    from abnet3_torch.dataloader import OriginalDataLoader
    orig = OriginalDataLoader.bank_batch_iterator

    def faulty(self, train_mode=True):
        for b in orig(self, train_mode):
            b.ids2s[0] = (b.ids2s[0] + 1) % len(self.token_bank)
            yield b
    monkeypatch.setattr(OriginalDataLoader, "bank_batch_iterator", faulty)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _wrong_token])
def test_train_faults_are_caught(fault, monkeypatch):
    fault(monkeypatch)
    assert not run_tiny(tiny_cell(TRAIN))["correct"]


def _gather_half(monkeypatch):
    from abnet3_torch import parallel
    make = parallel.make_frame_pair_steps

    def faulty(*a, **kw):
        train, evaluate = make(*a, **kw)

        def half(x1, x2, y, w, *rest):
            w = w.clone()
            w[1::2] = 0
            return train(x1, x2, y, w, *rest)
        return half, evaluate
    monkeypatch.setattr(parallel, "make_frame_pair_steps", faulty)


@pytest.mark.parametrize("fault", [_state_unchanged, _gather_half])
def test_gather_faults_are_caught(fault, monkeypatch):
    fault(monkeypatch)
    assert not run_tiny(tiny_cell(GATHER))["correct"]


def _altered_embeddings(monkeypatch):
    from abnet3_torch.embedder import EmbedderBuilder
    orig = EmbedderBuilder._embed_streaming

    def faulty(self, forward, stream, on_file_done, *a, **kw):
        def done(item, labels, embs):
            if item % 2 == 0:
                embs = [e + 1e-3 for e in embs]
            on_file_done(item, labels, embs)
        return orig(self, forward, stream, done, *a, **kw)
    monkeypatch.setattr(EmbedderBuilder, "_embed_streaming", faulty)


def _altered_distances(monkeypatch):
    from abnet3_torch.eval import abx
    orig = abx.distance_matrix

    def faulty(*a, **kw):
        D, handle = orig(*a, **kw)
        D = D.copy()
        D[::2] = np.clip(D[::2] + 0.01, 0, 1)
        return D, handle
    monkeypatch.setattr(abx, "distance_matrix", faulty)


def _altered_score(monkeypatch):
    from abnet3_torch.eval import abx_device
    orig = abx_device.abx_error_device

    def faulty(*a, **kw):
        out = dict(orig(*a, **kw))
        out["error"] += 1e-3
        return out
    monkeypatch.setattr(abx_device, "abx_error_device", faulty)


@pytest.mark.parametrize("fault", [_altered_embeddings, _altered_distances,
                                   _altered_score])
def test_eval_faults_are_caught(fault, monkeypatch):
    fault(monkeypatch)
    assert not run_tiny(tiny_cell(EVAL))["correct"]


@pytest.mark.parametrize("name", [TRAIN, "multitask-buckeye.bank-train",
                                  GATHER, EVAL])
def test_control_fails_a_limit(name, tmp_path):
    """The reference in TF32 (its products' operands rounded to TF32's
    mantissa) put in the program's place fails one of the cell's
    limits."""
    from h100_bench import run as harness
    from h100_bench.core.check import decide
    from h100_bench.tests.tiny import tiles_on_cpu
    cell = tiny_cell(name)
    with tiles_on_cpu():
        d = harness.driver_for(cell, 3, torch.device("cpu"), False,
                               str(tmp_path))
        d.setup()
        d.free()
        control = d.control_readings()["control_tf32"]
    assert not decide(control, cell.limits)[0], control


def _half_after_setup(monkeypatch, flag):
    """The split step weighs half of each batch 0 once ``flag`` is set:
    a fault that only the window's steps have."""
    from abnet3_torch import parallel
    make = parallel.make_split_pair_train_step

    def faulty(*a, **kw):
        train, evaluate = make(*a, **kw)

        def half(*args):
            if flag["on"]:
                args = list(args)
                for k in (2, 5):
                    w = args[k].clone()
                    w[1::2] = 0
                    args[k] = w
            return train(*args)
        return half, evaluate
    monkeypatch.setattr(parallel, "make_split_pair_train_step", faulty)


def test_window_only_fault_is_caught(monkeypatch, tmp_path):
    """A step that goes wrong after set-up passes the set-up steps' check
    and fails the check of the window's last epoch."""
    from h100_bench import run as harness
    from h100_bench.core.check import decide
    flag = {"on": False}
    _half_after_setup(monkeypatch, flag)
    cell = tiny_cell(TRAIN)
    d = harness.driver_for(cell, 11, torch.device("cpu"), False,
                           str(tmp_path))
    d.setup()
    flag["on"] = True
    d.window(0.0)
    d.free()
    numbers = d.check()
    limits = {k: v for k, v in cell.limits.items() if k != "bad_pairs"}
    assert decide(d.check_parts["setup"], limits)[0], d.check_parts
    assert not decide(d.check_parts["window_end"], limits)[0]
    assert not decide(numbers, cell.limits)[0]
