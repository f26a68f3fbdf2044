"""Operations and bytes of one ``dtw_moves`` launch (``csrc/dtw_moves.cu``):
the argmin move matrix of B same-word pairs padded to (B, T1, T2).

What these inputs need: each pair's n1 x n2 distances read once
(float32); the whole (B, T1, T2) int8 move matrix written. Operations:
per needed cell one add, two minimums and the move's choice (four)."""

from h100_bench.kernels.peaks import FP32_FLOPS, HBM_BYTES


def counts(n1, n2, T1: int, T2: int):
    cells = sum(a * b for a, b in zip(n1, n2))
    return 4 * cells, 4 * cells + len(n1) * T1 * T2


def bound_s(n1, n2, T1: int, T2: int) -> float:
    ops, nbytes = counts(n1, n2, T1, T2)
    return max(ops / FP32_FLOPS, nbytes / HBM_BYTES)
