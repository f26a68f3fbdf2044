"""``dtw_moves``'s share of its roofline in the traced slice: the launches
recorded there times the mean least time of a launch over the window's
batches (kernels/dtw_moves.py) over the kernel's recorded device time,
in %."""

from h100_bench.core.trace import kernel_time


def read(data: dict):
    tr = data.get("trace")
    bound = data["kernel_bounds"].get("dtw_moves")
    if not tr or bound is None:
        return None
    n, t = kernel_time(tr, "dtw_moves_kernel")
    return 100.0 * n * bound / t if n and t > 0 else None
