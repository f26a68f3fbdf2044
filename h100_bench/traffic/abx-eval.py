"""The ABX eval driver, which with ``--trace 1`` also reads the program's
own spans and counters (``core/spans.py``)."""

from h100_bench.core.abx import AbxDriver
from h100_bench.core.spans import ReadsSpans


class Driver(ReadsSpans, AbxDriver):
    rounds = "passes"
