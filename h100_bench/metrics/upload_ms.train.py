"""Host milliseconds of a bank batch's upload per train step (the
program's span ``train/step.upload`` over the count of ``train/step``)."""

from h100_bench.core import spans


def read(data: dict):
    v = spans.mean(data, "train/step.upload", per="train/step")
    return None if v is None else 1e3 * v
