"""Mean host milliseconds of one train step (the program's span
``train/step``: buffer flushes included; the step's upload, prepare,
forward, backward and optimizer step are its children)."""

from h100_bench.core import spans


def read(data: dict):
    v = spans.mean(data, "train/step")
    return None if v is None else 1e3 * v
