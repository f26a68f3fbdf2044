"""``abx_row_replay_share``: the program's row replays over its
``abx.row`` count, from hand-made totals and from a traced eval run on
the CPU, whose rows stay eager (the CUDA graph is the card's)."""

import pytest
import torch

from h100_bench.core.cell import metric_reader
from h100_bench.tests.tiny import tiles_on_cpu, tiny_cell

NAME = "abx_row_replay_share"


def _data(rows=None, replays=None):
    spans = {} if rows is None else {
        "abx.row": {"count": rows, "total_s": 1e-5 * rows,
                    "self_s": 1e-5 * rows}}
    counters = {} if replays is None else {"abx/row_replays": replays}
    return {"spans": {"spans": spans, "counters": counters}}


@pytest.mark.parametrize("rows,replays,share", [
    (10240, 10240, 1.0), (10240, 10239, 10239 / 10240), (1024, 512, 0.5),
    (1024, None, None), (None, 1024, None), (0, None, None)],
    ids=["every-row", "one-warm-up", "half", "no-counter", "no-rows",
         "no-span-count"])
def test_reader_on_hand_made_totals(rows, replays, share):
    got = metric_reader(NAME).read(_data(rows, replays))
    assert got == (None if share is None else pytest.approx(share))


def test_reader_without_the_programs_spans():
    read = metric_reader(NAME).read
    assert read({}) is None
    assert read({"spans": None}) is None


@pytest.fixture
def spans_restored():
    from abnet3_torch import profiling
    was = profiling._on
    try:
        yield
    finally:
        if not was:
            profiling.spans_off()


def test_traced_eval_run_on_the_cpu_reads_none(tmp_path, spans_restored):
    """The CPU's tiles run the eager rows: ``abx.row`` counts every row
    and no replay is counted, so the share is left out."""
    from h100_bench import run as harness
    cell = tiny_cell("siamese-buckeye.abx-eval")
    assert NAME in [m["name"] for m in cell.per_layer]
    with tiles_on_cpu():
        d = harness.driver_for(cell, 2 ** 31 + 23, torch.device("cpu"),
                               True, str(tmp_path))
        d.setup()
        d.window(0.0)
    data = d.layer_data()
    totals = data["spans"]
    assert totals["spans"]["abx.row"]["count"] == (
        d.tiles_per_pass() * cell.traffic["eval"]["block"])
    assert "abx/row_replays" not in totals["counters"]
    assert metric_reader(NAME).read(data) is None
