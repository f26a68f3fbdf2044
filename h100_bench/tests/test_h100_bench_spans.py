"""The per-layer metrics read from the program's own spans and counters
(``abnet3_torch.profiling``): each reader on synthetic data and without
its span, a traced run on the CPU whose spans match what the harness
counted, and the breakdown naming a gap after the program's span."""

import types

import pytest
import torch

from h100_bench.core import spans as program_spans
from h100_bench.core.cell import Cell, benchmark, metric_reader
from h100_bench.tests.tiny import tiles_on_cpu, tiny_cell


def _spans(**spans):
    return {"count": spans.pop("count"), "total_s": spans.pop("total_s"),
            "self_s": spans.pop("self_s", 0.0)}


TOTALS = {"spans": {
    "train/loader.wait": _spans(count=4, total_s=0.002),
    "train/loader.build": _spans(count=5, total_s=0.3),
    "train/loader.walk": _spans(count=10, total_s=0.1),
    "train/step": _spans(count=8, total_s=0.04),
    "train/step.optimizer": _spans(count=8, total_s=0.008),
    "train/step.upload": _spans(count=8, total_s=0.004),
    "abx.row": _spans(count=2048, total_s=0.1024),
    "abx.score.tables": _spans(count=4, total_s=0.6)},
    "counters": {"train/h2d_pageable_bytes": 10 * 1024 * 5}}

# metric -> (its value on TOTALS, the span or counter it cannot do without)
WANT = {"batch_wait_ms.train": (0.5, "train/loader.wait"),
        "step_host_ms.train": (5.0, "train/step"),
        "optimizer_ms.train": (1.0, "train/step.optimizer"),
        "upload_ms.train": (0.5, "train/step.upload"),
        "walk_ms.train": (20.0, "train/loader.walk"),
        "h2d_pageable_kb.train": (10.0, "train/h2d_pageable_bytes"),
        "abx_row_host_us": (50.0, "abx.row"),
        "abx_tables_ms": (300.0, "abx.score.tables")}


@pytest.mark.parametrize("name", list(WANT))
def test_reader_reads_its_span_and_nothing_without_it(name):
    value, needs = WANT[name]
    read = metric_reader(name).read
    assert read({"spans": TOTALS, "passes": 2}) == pytest.approx(value)
    cut = {"spans": {k: v for k, v in TOTALS["spans"].items()
                     if k != needs},
           "counters": {k: v for k, v in TOTALS["counters"].items()
                        if k != needs}}
    assert read({"spans": cut, "passes": 2}) is None
    # a program without spans: the driver's "spans" is None
    assert read({"spans": None, "passes": 2}) is None


def test_since_takes_the_stretch_and_none_for_an_older_program():
    before = {"spans": {"a": _spans(count=2, total_s=1.0, self_s=0.5)},
              "counters": {"b": 3}}
    after = {"spans": {"a": _spans(count=5, total_s=4.0, self_s=2.0),
                       "c": _spans(count=1, total_s=0.1, self_s=0.1)},
             "counters": {"b": 3, "d": 7}}
    got = program_spans.since(before, after)
    assert got == {"spans": {"a": _spans(count=3, total_s=3.0, self_s=1.5),
                             "c": _spans(count=1, total_s=0.1,
                                         self_s=0.1)},
                   "counters": {"d": 7}}
    assert program_spans.since(None, after) is None


@pytest.fixture
def spans_restored():
    from abnet3_torch import profiling
    was = profiling._on
    try:
        yield
    finally:
        if not was:
            profiling.spans_off()


def _stub_driver(trace):
    """A core driver's window in miniature: three rounds, one
    ``train/step`` each, the mark set after the first."""
    from abnet3_torch import profiling

    class Core:
        def __init__(self):
            self.trace, self.epochs = trace, 0

        def window(self, seconds):
            self.mark = None
            for _ in range(3):
                with profiling.span("train/step"):
                    pass
                self.epochs += 1
                if self.epochs == 1:
                    self.mark = "after the first"

        def layer_data(self):
            return {"passes": self.epochs}

    class Driver(program_spans.ReadsSpans, Core):
        rounds = "epochs"
    return Driver()


@pytest.mark.parametrize("trace", [False, True])
def test_spans_are_read_only_when_traced_and_after_the_mark(
        trace, spans_restored):
    from abnet3_torch import profiling
    profiling.spans_off()
    d = _stub_driver(trace)
    d.window(0.0)
    data = d.layer_data()
    assert d.mark == "after the first"
    if trace:
        assert data["spans"]["spans"]["train/step"]["count"] == 2
    else:
        assert "spans" not in data
        assert not profiling._on


def test_a_program_without_spans_reads_none(monkeypatch, spans_restored):
    """A program from before its tracing layer: the traced run gives
    ``"spans"`` None and every program-span reader leaves its metric
    out."""
    monkeypatch.setattr(program_spans, "_profiling", lambda: None)
    d = _stub_driver(True)
    d.window(0.0)
    data = d.layer_data()
    assert data["spans"] is None
    for name in WANT:
        assert metric_reader(name).read(data) is None


@pytest.mark.parametrize("name", sorted({
    w for m in benchmark()["per_layer"] if m["source"] == "program_span"
    and m["name"] in WANT for w in m["workloads"]}))
def test_cells_of_the_span_readers_run_a_driver_that_reads_spans(name):
    assert issubclass(Cell(name).traffic_code.Driver,
                      program_spans.ReadsSpans)


@pytest.mark.parametrize("name", ["siamese-buckeye.bank-train",
                                  "siamese-buckeye.gather-train"])
def test_traced_train_run_reads_the_programs_spans(tmp_path, name,
                                                   spans_restored):
    """A traced window (two epochs) carries the program's totals after
    the mark: one ``train/step`` per train batch that the harness's
    ``Feed`` counted after it, one wait and one build per batch."""
    from h100_bench import run as harness
    cell = tiny_cell(name)
    d = harness.driver_for(cell, 2 ** 31 + 9, torch.device("cpu"), True,
                           str(tmp_path))
    d.setup()
    d.window(0.0)
    assert d.epochs == 2
    data = d.layer_data()
    spans = data["spans"]["spans"]
    n_batches = len(d.feed.build_s) - d.mark[1]
    assert n_batches > 0
    assert spans["train/step"]["count"] == n_batches
    assert spans["train/loader.wait"]["count"] == n_batches
    assert spans["train/loader.build"]["count"] == n_batches
    for m in cell.per_layer:
        if m["source"] == "program_span" and m["name"] in WANT:
            assert metric_reader(m["name"]).read(data) is not None, m


def test_traced_eval_run_reads_the_programs_spans(tmp_path, spans_restored):
    from h100_bench import run as harness
    cell = tiny_cell("siamese-buckeye.abx-eval")
    with tiles_on_cpu():
        d = harness.driver_for(cell, 2 ** 31 + 9, torch.device("cpu"), True,
                               str(tmp_path))
        d.setup()
        d.window(0.0)
    data = d.layer_data()
    spans = data["spans"]["spans"]
    assert data["passes"] == d.passes - 1 == 1
    assert spans["abx.score"]["count"] == 2            # across, within
    assert spans["abx.row"]["count"] == (d.tiles_per_pass()
                                         * cell.traffic["eval"]["block"])
    for name in ("abx_row_host_us", "abx_tables_ms"):
        assert metric_reader(name).read(data) > 0


def test_breakdown_names_a_gap_after_the_program_span():
    """``summarize`` names an idle gap after the innermost host event at
    its middle: the program's span there, else the harness's words."""
    from torch.autograd import DeviceType

    from h100_bench.core.trace import summarize

    def ev(name, start, end, device=DeviceType.CPU):
        return types.SimpleNamespace(
            name=name, device_type=device, is_user_annotation=False,
            time_range=types.SimpleNamespace(start=start, end=end))
    cuda = DeviceType.CUDA
    events = [ev("ProfilerStep#1", 0.0, 10_000.0),
              ev("kernel_a", 0.0, 1_000.0, cuda),
              ev("kernel_b", 5_000.0, 6_000.0, cuda),
              ev("kernel_c", 9_500.0, 10_000.0, cuda),
              ev("train/step", 500.0, 5_200.0),
              ev("train/step.optimizer", 1_200.0, 4_800.0),
              ev("aten::add_", 1_300.0, 1_400.0)]
    gaps = summarize(events)["gaps"]
    assert gaps[0] == ["train/step.optimizer", pytest.approx(0.004)]
    assert gaps[1] == ["host, outside any op", pytest.approx(0.0035)]


def test_idle_time_splits_by_the_main_threads_program_span():
    """``idle_spans.account``: each idle instant goes to the innermost
    program span open on the main thread (the profiler's steps' thread);
    other threads' spans and the program's ops name nothing; a long gap
    outside every span is the profiler's step or the harness."""
    from torch.autograd import DeviceType

    from h100_bench.idle_spans import account

    def ev(name, start, end, device=DeviceType.CPU, thread=1):
        return types.SimpleNamespace(
            name=name, device_type=device, is_user_annotation=False,
            thread=thread, time_range=types.SimpleNamespace(start=start,
                                                            end=end))
    cuda = DeviceType.CUDA
    events = [ev("ProfilerStep#1", 0.0, 10_000.0),
              ev("ProfilerStep#2", 10_000.0, 40_000.0),
              ev("k", 0.0, 1_000.0, cuda), ev("k", 5_000.0, 6_000.0, cuda),
              ev("k", 39_000.0, 40_000.0, cuda),
              ev("train/step", 500.0, 5_200.0),
              ev("train/step.optimizer", 1_200.0, 4_800.0),
              ev("aten::add_", 1_300.0, 1_400.0),
              ev("train/loader.wait", 6_500.0, 8_000.0),
              ev("train/loader.build", 0.0, 40_000.0, thread=2)]
    got = account(events, min_gap_s=0.010)
    assert got["idle_s"] == pytest.approx(0.037)
    assert got["by_span"] == {"train/step.optimizer": pytest.approx(0.0036),
                              "train/loader.wait": pytest.approx(0.0015),
                              "train/step": pytest.approx(0.0004)}
    assert got["outside"] == pytest.approx(0.0315)
    (gap,) = got["gaps"]
    assert gap[:2] == [pytest.approx(0.006), pytest.approx(0.033)]
    assert gap[2] == {"train/loader.wait": pytest.approx(0.0015),
                      "profiler step": pytest.approx(0.0315)}
