"""Operations and bytes of one ``dtw_path`` launch (``csrc/dtw_path.cu``):
the DTW path mask of B same-word pairs in a (B, T, T) bucket.

What these inputs need: each pair's n1 x n2 distances read once (float32)
and its lengths; the whole (B, T, T) float32 mask written (its zeros are
part of the answer). Operations: per needed cell one add and two
minimums of the recurrence, and per path step one move read (counted as
one operation per cell of the path's bound n1 + n2)."""

from h100_bench.kernels.peaks import FP32_FLOPS, HBM_BYTES


def counts(n1, n2, T1: int, T2: int):
    """(operations, bytes) of one launch; n1, n2 the pairs' lengths."""
    cells = sum(a * b for a, b in zip(n1, n2))
    ops = 3 * cells + sum(a + b for a, b in zip(n1, n2))
    nbytes = 4 * cells + 8 * len(n1) + 4 * len(n1) * T1 * T2
    return ops, nbytes


def bound_s(n1, n2, T1: int, T2: int) -> float:
    ops, nbytes = counts(n1, n2, T1, T2)
    return max(ops / FP32_FLOPS, nbytes / HBM_BYTES)
