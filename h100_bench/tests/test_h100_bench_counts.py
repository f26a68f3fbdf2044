"""FLOP and byte counts against hand counts at a tiny size."""

import pytest

from h100_bench.core.cell import Config, kernel_counts
from h100_bench.core.flops import ModelFlops
from h100_bench.kernels.peaks import FP32_FLOPS, HBM_BYTES


def test_dtw_path_counts_by_hand():
    k = kernel_counts("dtw_path")
    # pairs of 2x3 and 4x4 frames in a (2, 4, 4) bucket
    ops, nbytes = k.counts([2, 4], [3, 4], 4, 4)
    assert ops == 3 * (6 + 16) + (5 + 8)
    assert nbytes == 4 * (6 + 16) + 8 * 2 + 4 * 2 * 4 * 4
    assert k.bound_s([2, 4], [3, 4], 4, 4) == pytest.approx(
        max(ops / FP32_FLOPS, nbytes / HBM_BYTES))


def test_dtw_moves_and_stats_counts_by_hand():
    ops, nbytes = kernel_counts("dtw_moves").counts([2], [3], 4, 4)
    assert (ops, nbytes) == (4 * 6, 4 * 6 + 16)
    ops, nbytes = kernel_counts("dtw_path_stats").counts(3, [2, 5])
    assert ops == 4 * 21
    assert nbytes == 4 * 21 + 4 * 3 + 8 * 2


def test_model_flops_by_hand():
    mf = ModelFlops(Config("siamese-buckeye"))
    tower = 2 * (280 * 500 + 500 * 500 + 500 * 500 + 500 * 100)
    assert mf.tower == tower
    # one same pair of 2 and 3 frames, one diff pair of 4 and 1, training
    got = mf.pairs([2, 4], [3, 1], [True, False], True)
    want = (3 * tower * (5 + 5) + 2 * 280 * 6 + 3 * 6
            + 3 * 2 * 100 * (5 + 1))
    assert got == want
    assert mf.export(7) == tower * 7
    multi = ModelFlops(Config("multitask-buckeye"))
    assert multi.tower == 2 * (280 * 500 + 500 * 500
                               + 2 * (500 * 500 + 500 * 100))
    assert multi.heads == 200
