"""Host milliseconds a train step spends in the integration unit, its
attention gate and the fusion (the program's span ``train/mm.integration``,
both branches, over the count of ``train/step``)."""

from h100_bench.core import spans


def read(data: dict):
    v = spans.mean(data, "train/mm.integration", per="train/step")
    return None if v is None else 1e3 * v
