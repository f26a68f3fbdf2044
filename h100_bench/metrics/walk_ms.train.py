"""Host milliseconds of ``walk_moves`` per train batch built (the
program's span ``train/loader.walk`` over the count of
``train/loader.build``, on the prefetch thread)."""

from h100_bench.core import spans


def read(data: dict):
    v = spans.mean(data, "train/loader.walk", per="train/loader.build")
    return None if v is None else 1e3 * v
