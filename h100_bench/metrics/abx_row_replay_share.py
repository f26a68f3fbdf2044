"""Share of the ABX tile loop's anchor rows that replayed the row's CUDA
graph: the program's counter ``abx/row_replays`` over the count of its
span ``abx.row``. A run without the counter (a program that has no
graphed rows, or the CPU, whose rows stay eager) or without the span
reads None."""


def read(data: dict):
    totals = data.get("spans") or {}
    rows = totals.get("spans", {}).get("abx.row", {}).get("count", 0)
    replays = totals.get("counters", {}).get("abx/row_replays")
    return replays / rows if rows and replays is not None else None
