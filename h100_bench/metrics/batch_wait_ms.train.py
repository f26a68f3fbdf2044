"""Mean milliseconds the trainer's main thread waits for each train batch
(the program's span ``train/loader.wait``: the prefetch queue's ``get``,
or the build itself without prefetch)."""

from h100_bench.core import spans


def read(data: dict):
    v = spans.mean(data, "train/loader.wait")
    return None if v is None else 1e3 * v
