"""Share of the train steps that replayed a CUDA graph (the program's
counter ``train/graph_replays`` over the count of ``train/step``); a
program without the counter reads None."""


def read(data: dict):
    totals = data.get("spans") or {}
    n = totals.get("spans", {}).get("train/step", {}).get("count")
    replays = totals.get("counters", {}).get("train/graph_replays")
    return replays / n if replays is not None and n else None
