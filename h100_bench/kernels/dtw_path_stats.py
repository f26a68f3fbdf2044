"""Operations and bytes of one ``dtw_path_stats`` launch
(``csrc/dtw_path_stats.cu``): one ABX anchor of n1 frames against a tile's
B column tokens, in the rows layout (T1, B, T2); out the path sum and the
path length of each pair.

What these inputs need: the n1 x n2 distances of each pair read once
(float32) and the lengths; two float32 values a pair written.
Operations: per needed cell one add, two minimums and the length's
choice (four)."""

from h100_bench.kernels.peaks import FP32_FLOPS, HBM_BYTES


def counts(n1: int, n2):
    cells = n1 * sum(n2)
    return 4 * cells, 4 * cells + 4 * (len(n2) + 1) + 8 * len(n2)


def bound_s(n1: int, n2) -> float:
    ops, nbytes = counts(n1, n2)
    return max(ops / FP32_FLOPS, nbytes / HBM_BYTES)
