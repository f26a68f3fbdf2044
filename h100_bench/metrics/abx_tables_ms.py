"""Milliseconds of the device scorer's host tables per pass (the program's
span ``abx.score.tables``, both tasks, over the passes read)."""


def read(data: dict):
    s = (data.get("spans") or {}).get("spans", {}).get("abx.score.tables")
    n = data.get("passes")
    return 1e3 * s["total_s"] / n if s and n else None
