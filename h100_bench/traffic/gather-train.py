"""The general train driver, which with ``--trace 1`` also reads the
program's own spans and counters (``core/spans.py``)."""

from h100_bench.core.spans import ReadsSpans
from h100_bench.core.train import TrainDriver


class Driver(ReadsSpans, TrainDriver):
    rounds = "epochs"
