"""The strip kernels' launch geometry and lane-skewed schedule, rehearsed
on the CPU: the emulation of ``abnet3_torch/ops/strip_schedule.py``
computes every cell exactly once, after its three neighbours, and gives
the plain versions' costs, moves and path statistics bit for bit (which
``tests/test_torch_dtw.py`` holds against the JAX scan and Pallas
interpret). Also the build key of the kernel libraries."""

import os
import shutil

import numpy as np
import pytest
import torch

from abnet3_torch.ops import cuda_dtw
from abnet3_torch.ops.cuda_dtw import (SMEM_LIMIT, STRIP_PREFETCH,
                                       dtw_path_stats_plain, strip_geometry)
from abnet3_torch.ops.dtw import dtw_costs, moves_from_costs
from abnet3_torch.ops.strip_schedule import emulate_strip, ring_schedule

# (B, T1, T2): the smoke's buckets (at a small B: the schedule of a pair
# does not depend on the batch), T2 not a multiple of 32 or of 4, T1 !=
# T2, each strip width, the first shape past the widest strip, and wide
# chunked planes
SHAPES = [(3, 128, 128), (3, 96, 96), (2, 64, 64), (2, 32, 32),
          (2, 40, 72), (2, 128, 64), (2, 50, 37), (2, 33, 100),
          (2, 7, 1), (2, 1, 9), (1, 70, 129), (2, 40, 300), (1, 300, 500)]


def _dist(kind, shape, seed=11):
    rng = np.random.RandomState(seed)
    if kind == "ties":
        return rng.randint(0, 3, shape).astype(np.float32)
    return rng.rand(*shape).astype(np.float32)


def _lengths(shape, seed=12):
    """Ragged lengths with 1 and T among them."""
    B, T1, T2 = shape
    rng = np.random.RandomState(seed)
    n1 = rng.randint(1, T1 + 1, B).astype(np.int32)
    n2 = rng.randint(1, T2 + 1, B).astype(np.int32)
    n1[0], n2[0] = T1, T2
    if B > 1:
        n1[1], n2[1] = 1, max(1, T2 // 2)
    if B > 2:
        n1[2], n2[2] = T1, 1
    return n1, n2


def _bits(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.int32)


def _check_order(run, n1, n2, W):
    """Every cell of each pair's sub-grid once, its neighbours before it:
    a neighbour in another lane's strip in an earlier step (it arrives by
    a shuffle or a carried column), one in the same strip earlier in the
    same step or in an earlier step."""
    chunk = 32 * W
    for b in range(run.count.shape[0]):
        a, c = int(n1[b]), int(n2[b])
        inside = np.zeros(run.count.shape[1:], bool)
        inside[:a, :c] = True
        assert (run.count[b][inside] == 1).all()
        assert (run.count[b][~inside] == 0).all()
        step, slot = run.step[b, :a, :c], run.slot[b, :a, :c]
        col = np.arange(c)[None, :]
        assert (slot == (col % chunk) % W).all()
        first = np.broadcast_to(slot == 0, step.shape)
        # up: the same lane, the step before
        assert (step[1:] == step[:-1] + 1).all()
        # left: the same step inside a strip, an earlier one across strips
        same = ~first[:, 1:]
        assert (step[:, 1:][same] == step[:, :-1][same]).all()
        assert (step[:, 1:][~same] > step[:, :-1][~same]).all()
        # diag: the step before inside a strip; across strips it is the
        # shuffled value of the step before, so at least two steps back
        same = ~first[1:, 1:]
        assert (step[1:, 1:][same] == step[:-1, :-1][same] + 1).all()
        assert (step[1:, 1:][~same] >= step[:-1, :-1][~same] + 2).all()


@pytest.mark.parametrize("kind", ["uniform", "ties"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_schedule_gives_plain_costs_and_moves(kind, shape):
    dist = _dist(kind, shape)
    run = emulate_strip(dist)
    B, T1, T2 = shape
    geo = strip_geometry(B, T1, T2)
    _check_order(run, [T1] * B, [T2] * B, geo.strip)
    D = dtw_costs(torch.from_numpy(dist))
    assert np.array_equal(_bits(run.costs), _bits(D.numpy()))
    assert np.array_equal(run.moves, moves_from_costs(D).numpy())
    assert (run.steps == geo.steps(T1, T2)).all()
    if kind == "uniform":     # finite costs: the TPU kernel's border
        assert run.moves[:, 0, 0].tolist() == [3] * B
        assert (run.moves[:, 0, 1:] == 1).all()
        assert (run.moves[:, 1:, 0] == 2).all()


@pytest.mark.parametrize("kind", ["uniform", "ties"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_schedule_gives_plain_path_stats(kind, shape):
    dist = _dist(kind, shape, seed=13)
    n1, n2 = _lengths(shape)
    run = emulate_strip(dist, n1, n2)
    B, T1, T2 = shape
    geo = strip_geometry(B, T1, T2, carry_words=2)
    _check_order(run, n1, n2, geo.strip)
    psum, plen = dtw_path_stats_plain(torch.from_numpy(dist),
                                      torch.from_numpy(n1),
                                      torch.from_numpy(n2))
    assert np.array_equal(_bits(run.psum), _bits(psum.numpy()))
    assert np.array_equal(run.plen, plen.numpy())
    # the result cell (a-1, c-1) belongs to lane (c-1) // W of its chunk
    # and is ready at the pair's last step
    for b in range(B):
        a, c = int(n1[b]), int(n2[b])
        assert run.steps[b] == geo.steps(a, c)
        assert run.step[b, a - 1, c - 1] == run.step[b].max()


def test_schedule_lengths_outside_the_plane_give_zero():
    dist = _dist("uniform", (4, 9, 40))
    n1 = np.array([0, 10, 5, 9], np.int32)
    n2 = np.array([7, 7, 41, 40], np.int32)
    run = emulate_strip(dist, n1, n2)
    psum, plen = dtw_path_stats_plain(torch.from_numpy(dist),
                                      torch.from_numpy(n1),
                                      torch.from_numpy(n2))
    assert np.array_equal(_bits(run.psum), _bits(psum.numpy()))
    assert np.array_equal(run.plen, plen.numpy())
    assert run.psum[:3].tolist() == [0, 0, 0] and run.plen[3] > 0
    assert (run.count[:3] == 0).all()


@pytest.mark.parametrize("shape,words,expect", [
    # the ABX tile row: W = 4 on 24 lanes, 8 pairs a block, all 1,024 in
    # one wave
    ((1024, 96, 96), 2, dict(strip=4, chunks=1, lanes=24, pitch=96,
                             ring_rows=32, warps=8, blocks=128)),
    # the gather path's batch: one pair a block, over 32 SMs
    ((32, 128, 128), 1, dict(strip=4, chunks=1, lanes=32, pitch=128,
                             ring_rows=40, warps=1, blocks=32)),
    ((64, 96, 96), 1, dict(strip=4, lanes=24, warps=1, blocks=64)),
    ((1024, 64, 64), 2, dict(strip=2, lanes=32, pitch=64)),
    ((1024, 32, 32), 2, dict(strip=1, lanes=32, pitch=32)),
    ((1025, 50, 37), 2, dict(strip=2, lanes=19, pitch=40, ring_rows=27,
                             warps=8, blocks=129)),
    ((1, 64, 100), 1, dict(strip=4, lanes=25, pitch=100, warps=1,
                           blocks=1)),
    # past the widest strip: column chunks, a carried column of T1 words
    ((4, 70, 129), 1, dict(strip=4, chunks=2, lanes=32,
                           warp_floats=40 * 128 + 72)),
    ((4, 1024, 1024), 1, dict(strip=4, chunks=8,
                              warp_floats=40 * 128 + 1024)),
    ((64, 512, 512), 2, dict(strip=4, chunks=4,
                             warp_floats=40 * 128 + 1024)),
    # a long carry leaves room for fewer pairs in a block
    ((2000, 9000, 200), 2, dict(chunks=2, warps=2, blocks=1000)),
])
def test_strip_geometry(shape, words, expect):
    geo = strip_geometry(*shape, carry_words=words)
    for key, value in expect.items():
        assert getattr(geo, key) == value, (key, geo)
    assert geo.ring_rows == geo.lanes + STRIP_PREFETCH
    assert geo.pitch % 4 == 0 and geo.pitch >= geo.lanes * geo.strip
    assert geo.strip in (1, 2, 4)
    assert geo.lanes <= 32 and geo.strip * 32 * geo.chunks >= shape[2]
    assert geo.blocks * geo.warps >= shape[0]
    assert geo.smem_bytes <= SMEM_LIMIT


def test_strip_geometry_steps():
    """T1 + lanes - 1 steps a chunk, against the T1 + T2 - 1 barrier steps
    of an anti-diagonal wavefront."""
    assert strip_geometry(1024, 96, 96, 2).steps(96, 96) == 96 + 24 - 1
    assert strip_geometry(1024, 96, 96, 2).steps(96, 20) == 96 + 5 - 1
    assert strip_geometry(32, 128, 128).steps(128, 128) == 159
    assert strip_geometry(4, 1024, 1024).steps(1024, 1024) == 8 * 1055
    assert strip_geometry(4, 70, 129).steps(70, 129) == 101 + 70


def test_wrappers_refuse_a_carry_past_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        cuda_dtw._check_strip_fits(2, 60000, 130, carry_words=1)
    cuda_dtw._check_strip_fits(2, 60000, 128, carry_words=1)
    cuda_dtw._check_strip_fits(2, 20000, 130, carry_words=2)


@pytest.mark.parametrize("rows,lanes", [(1, 1), (1, 32), (5, 32), (8, 3),
                                        (9, 32), (96, 32), (128, 32),
                                        (200, 19), (300, 1)])
def test_ring_never_hands_a_lane_another_row(rows, lanes):
    reads = ring_schedule(rows, lanes, lanes + STRIP_PREFETCH)
    assert reads == rows * lanes


def test_ring_one_row_short_is_caught():
    """The check has teeth: a ring without room for the prefetched rows
    overwrites a row that a lagging lane still has to read."""
    with pytest.raises(AssertionError):
        ring_schedule(96, 32, 32 + STRIP_PREFETCH - 2)


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """The kernel sources copied aside, and the build key looking there."""
    copy = tmp_path / "csrc"
    shutil.copytree(cuda_dtw.CSRC, copy)
    monkeypatch.setattr(cuda_dtw, "CSRC", str(copy))
    return copy


@pytest.mark.parametrize("name", ["dtw_moves", "dtw_path_stats"])
def test_build_key_covers_included_headers(csrc_copy, name):
    files = [os.path.basename(p) for p in cuda_dtw.source_files(name)]
    assert files == [f"{name}.cu", "dtw_strip.cuh"]
    before = cuda_dtw.library_path(name)
    assert before == cuda_dtw.library_path(name)
    with open(csrc_copy / "dtw_strip.cuh", "ab") as fh:
        fh.write(b"// edited\n")
    after = cuda_dtw.library_path(name)
    assert after != before
    with open(csrc_copy / f"{name}.cu", "ab") as fh:
        fh.write(b"// edited\n")
    assert cuda_dtw.library_path(name) not in (before, after)


def test_build_key_leaves_other_sources_alone(csrc_copy, monkeypatch):
    """dtw_path.cu includes no header of csrc/: a header edit keeps its
    library; a change of the compiler flags renames every library."""
    assert [os.path.basename(p) for p in cuda_dtw.source_files("dtw_path")] \
        == ["dtw_path.cu"]
    before = cuda_dtw.library_path("dtw_path")
    with open(csrc_copy / "dtw_strip.cuh", "ab") as fh:
        fh.write(b"// edited\n")
    assert cuda_dtw.library_path("dtw_path") == before
    monkeypatch.setattr(cuda_dtw, "NVCC_FLAGS",
                        cuda_dtw.NVCC_FLAGS + ["-lineinfo"])
    assert cuda_dtw.library_path("dtw_path") != before
