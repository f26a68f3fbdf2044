"""Share of the frame-table steps, train and dev, that replayed a CUDA
graph: the program's counters ``train/graph_replays`` and
``dev/graph_replays`` over the counts of ``train/step`` and ``dev/step``
(the dev pass is a large part of the frame cell's epoch). A counter that
did not move is left out of the totals and counts 0; a run without the
program's spans reads None."""

STEPS = ("train/step", "dev/step")
REPLAYS = ("train/graph_replays", "dev/graph_replays")


def read(data: dict):
    totals = data.get("spans") or {}
    spans, counters = totals.get("spans", {}), totals.get("counters", {})
    n = sum(spans.get(k, {}).get("count", 0) for k in STEPS)
    return sum(counters.get(k, 0) for k in REPLAYS) / n if n else None
