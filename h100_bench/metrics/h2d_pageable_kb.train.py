"""KiB copied from pageable host memory to the card per train batch built
(the program's counter ``train/h2d_pageable_bytes`` over the count of
``train/loader.build``)."""


def read(data: dict):
    totals = data.get("spans") or {}
    n = totals.get("spans", {}).get("train/loader.build", {}).get("count")
    b = totals.get("counters", {}).get("train/h2d_pageable_bytes")
    return b / 1024 / n if b and n else None
