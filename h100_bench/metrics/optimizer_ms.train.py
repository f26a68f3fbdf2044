"""Host milliseconds of the optimizer step per train step (the program's
span ``train/step.optimizer`` over the count of ``train/step``)."""

from h100_bench.core import spans


def read(data: dict):
    v = spans.mean(data, "train/step.optimizer", per="train/step")
    return None if v is None else 1e3 * v
