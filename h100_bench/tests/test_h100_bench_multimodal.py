"""The multimodal cell (``multimodal-buckeye.frame-train``) at a tiny size
on the CPU: its files are found by name, modality B is its own draw over
the corpus's tokens, a sound run is correct, and each fault of the
program, the control and the planted faults are not."""

import numpy as np
import pytest
import torch

from h100_bench.core.cell import Cell
from h100_bench.tests.tiny import run_tiny, tiny_cell

CELL = "multimodal-buckeye.frame-train"


def mm_tiny() -> Cell:
    """The cell cut to the CPU: 600 word pairs, 64-row batches, 8 a train
    pass (one call of ``steps_per_call`` 8, so the held steps come back
    through ``give_batch_to_network``)."""
    cell = tiny_cell(CELL)
    t = cell.traffic
    t["pairs"]["n_pairs"] = 600
    t["loader"].pop("num_max_minibatches")
    t["loader"].update(batch_size=64, max_batches_per_epoch=8)
    t["first_steps"]["batches"] = 8
    return cell


def test_cell_files_are_found_by_name():
    cell = Cell(CELL)
    assert cell.config.name == "multimodal-buckeye"
    assert cell.traffic["corpus_b"] == "zerospeech-buckeye-b273"
    code = cell.traffic_code
    assert code.Driver.rounds == "epochs"
    assert code.Batches is not None
    assert {"grad_gap_attention", "update_gap_attention",
            "bad_pairs", "pairs_not_whole"} <= set(cell.limits)
    names = {m["name"] for m in cell.per_layer}
    assert {"premodal_ms.train", "integration_ms.train",
            "mm_gather_kb.train"} <= names
    assert {m["name"] for m in cell.end_to_end} == {"train_pairs_per_s",
                                                    "setup_s"}
    shapes = cell.config.reference.shapes(cell.config.values)
    assert shapes["pre_0/layer_0"] == (280, 500)
    assert shapes["pre_1/layer_0"] == (273, 500)
    assert shapes["integration/linear1/layer_0"] == (500, 1)
    assert shapes["post/layer_1"] == (500, 100)


def test_modality_b_has_as_frame_counts_and_is_not_a():
    from h100_bench.core.corpus import make_corpus
    cell = mm_tiny()
    code, t = cell.traffic_code, cell.traffic
    p_b = {"dim": 273, "proto_len": 48, "speaker_scale": 0.5, "noise": 0.6}
    dev = torch.device("cpu")
    corpus = make_corpus(t["corpus"], 77, dev)
    b = code.modality_b(corpus, t["corpus"], p_b, 77, dev)
    assert [len(x) for x in b] == [len(x) for x in corpus.frames]
    assert all(x.shape[1] == 273 and x.dtype == np.float32 for x in b)
    a_all, b_all = np.concatenate(corpus.frames), np.concatenate(b)
    assert not np.allclose(a_all[:, :273], b_all)
    # its own draw: uncorrelated with A, the same again from the seed,
    # another from another seed
    corr = np.corrcoef(a_all[:, 0], b_all[:, 0])[0, 1]
    assert abs(corr) < 0.2
    again = code.modality_b(corpus, t["corpus"], p_b, 77, dev)
    assert all(np.array_equal(x, y) for x, y in zip(b, again))
    other = code.modality_b(make_corpus(t["corpus"], 78, dev), t["corpus"],
                            p_b, 78, dev)
    assert not np.array_equal(b[0][:5], other[0][:5])
    # the noise is B's own, twice A's: frames of one class vary more
    assert b_all.std() > a_all.std()


def test_sound_run_is_correct():
    res = run_tiny(mm_tiny())
    over = {k: e for k, e in res["checks"].items()
            if not e["value"] <= e["limit"]}
    assert not over, over
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0


def _attention_at_main_lr(monkeypatch):
    from abnet3_torch.trainer import MultimodalTrainer
    build = MultimodalTrainer._build_effective_optimizer

    def faulty(self):
        opt = build(self)
        for g in opt.param_groups:
            g["lr"] = self.lr
        return opt
    monkeypatch.setattr(MultimodalTrainer, "_build_effective_optimizer",
                        faulty)


def _b_table_swapped_for_a(monkeypatch):
    from abnet3_torch.dataloader import MultimodalDataLoader
    tables = MultimodalDataLoader.frame_tables

    def faulty(self, train_mode=True):
        a, b = tables(self, train_mode)
        return a, a[:, :b.shape[1]].contiguous()
    monkeypatch.setattr(MultimodalDataLoader, "frame_tables", faulty)


def _gate_frozen(monkeypatch):
    from abnet3_torch.trainer import MultimodalTrainer
    init = MultimodalTrainer.__init__

    def faulty(self, *a, **kw):
        init(self, *a, **kw)
        self.network.integration_unit.set_headstart_weight(0.5)
    monkeypatch.setattr(MultimodalTrainer, "__init__", faulty)


def _half_batch(monkeypatch):
    from abnet3_torch import parallel
    make = parallel.make_frame_train_step

    def faulty(*a, **kw):
        train, evaluate = make(*a, **kw)

        def half(i1, i2, y, w):
            w = w.clone()
            w[1::2] = 0
            return train(i1, i2, y, w)
        return half, evaluate
    monkeypatch.setattr(parallel, "make_frame_train_step", faulty)


@pytest.mark.parametrize("fault", [_attention_at_main_lr,
                                   _b_table_swapped_for_a, _gate_frozen,
                                   _half_batch])
def test_program_faults_are_caught(fault, monkeypatch):
    fault(monkeypatch)
    assert not run_tiny(mm_tiny())["correct"]


def _frames_dropped(keep):
    """A loader whose split's frame pairs lose the rows ``keep`` refuses."""
    def fault(monkeypatch):
        from abnet3_torch.dataloader import MultimodalDataLoader
        load = MultimodalDataLoader.load_all_frames

        def faulty(self, pairs):
            table, frames = load(self, pairs)
            return table, frames[keep(frames)]
        monkeypatch.setattr(MultimodalDataLoader, "load_all_frames",
                            faulty)
    return fault


def _aligned_euclidean(monkeypatch):
    """Whole paths, but optimal under another distance."""
    from abnet3_torch.ops import dtw
    monkeypatch.setattr(dtw, "pairwise_angular_distance",
                        lambda x, y: torch.cdist(x.float(), y.float()))


LOADER_FAULTS = {
    # every fifth same cell gone
    "same_cells_dropped": (_frames_dropped(
        lambda f: (f[:, 2] < 0) | (np.arange(len(f)) % 5 != 0)), True),
    # the diagonal frames of odd first rows gone
    "diff_frames_dropped": (_frames_dropped(
        lambda f: (f[:, 2] > 0) | (f[:, 0] % 2 == 0)), True),
    "aligned_euclidean": (_aligned_euclidean, False),
}


@pytest.mark.parametrize("name", list(LOADER_FAULTS))
def test_loader_that_holds_pairs_in_part_is_caught(name, monkeypatch):
    """The held steps' numbers cannot see a loader that trains on part of
    the aligned data; ``pairs_not_whole`` does (for a drop, alone)."""
    fault, alone = LOADER_FAULTS[name]
    fault(monkeypatch)
    res = run_tiny(mm_tiny())
    over = {k for k, e in res["checks"].items()
            if not e["value"] <= e["limit"]}
    assert not res["correct"] and "pairs_not_whole" in over, over
    if alone:
        assert over == {"pairs_not_whole"}


def test_control_and_planted_faults_fail_a_limit(tmp_path):
    """The reference in TF32, with half of each batch left out and with
    its gate held at 0.5, each in the program's place, fails a limit;
    the held gate fails one of the gate's own numbers."""
    from h100_bench import run as harness
    from h100_bench.core.check import decide
    cell = mm_tiny()
    d = harness.driver_for(cell, 3, torch.device("cpu"), False,
                           str(tmp_path))
    d.setup()
    d.free()
    readings = d.control_readings()
    assert set(readings) == {"control_tf32", "fault_half_batch",
                             "fault_fixed_gate"}
    for name, numbers in readings.items():
        assert not decide(numbers, cell.limits)[0], (name, numbers)
    gate = readings["fault_fixed_gate"]
    assert gate["grad_gap_attention"] > cell.limits["grad_gap_attention"]


NEW_READERS = {"premodal_ms.train": 3.0, "integration_ms.train": 1.0,
               "mm_gather_kb.train": 2.0}


@pytest.mark.parametrize("name", list(NEW_READERS))
def test_new_readers_read_their_spans_and_nothing_without(name):
    from h100_bench.core.cell import metric_reader

    def span(count, total_s):
        return {"count": count, "total_s": total_s, "self_s": total_s}
    totals = {"spans": {"train/step": span(4, 0.1),
                        "train/mm.pre_0": span(8, 0.008),
                        "train/mm.pre_1": span(8, 0.004),
                        "train/mm.integration": span(8, 0.004)},
              "counters": {"train/mm_gather_bytes": 4 * 2048}}
    read = metric_reader(name).read
    assert read({"spans": totals}) == pytest.approx(NEW_READERS[name])
    # an older program: no spans at all, or none of the multimodal ones
    assert read({"spans": None}) is None
    assert read({"spans": {"spans": {"train/step": span(4, 0.1)},
                           "counters": {}}}) is None


def test_traced_run_reads_the_new_spans(tmp_path):
    from h100_bench import run as harness
    from h100_bench.core.cell import metric_reader
    from abnet3_torch import profiling
    was = profiling._on
    try:
        cell = mm_tiny()
        d = harness.driver_for(cell, 2 ** 31 + 9, torch.device("cpu"), True,
                               str(tmp_path))
        d.setup()
        d.window(0.0)
        data = d.layer_data()
    finally:
        if not was:
            profiling.spans_off()
    assert d.epochs == 2
    n_steps = data["spans"]["spans"]["train/step"]["count"]
    assert n_steps == cell.traffic["loader"]["max_batches_per_epoch"]
    rows = cell.traffic["loader"]["batch_size"]
    assert metric_reader("mm_gather_kb.train").read(data) == pytest.approx(
        2 * rows * (280 + 273) * 4 / 1024)
    for m in cell.per_layer:
        if m["source"] in ("program_span", "program_counter"):
            assert metric_reader(m["name"]).read(data) is not None, m
