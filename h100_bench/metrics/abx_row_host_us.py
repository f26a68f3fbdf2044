"""Mean host microseconds of one anchor row of the ABX tile loop (the
program's span ``abx.row``: the anchor's distance rows, the stats
launch and the division, as dispatched)."""

from h100_bench.core import spans


def read(data: dict):
    v = spans.mean(data, "abx.row")
    return None if v is None else 1e6 * v
