"""KiB a train step gathers from the modality tables (the program's
counter ``train/mm_gather_bytes``, both sides' rows of every table, over
the count of ``train/step``)."""


def read(data: dict):
    totals = data.get("spans") or {}
    n = totals.get("spans", {}).get("train/step", {}).get("count")
    b = totals.get("counters", {}).get("train/mm_gather_bytes")
    return b / 1024 / n if b and n else None
