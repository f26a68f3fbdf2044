"""The strip kernels' launch geometry and lane-skewed schedule, rehearsed
on the CPU: the emulation of ``abnet3_torch/ops/strip_schedule.py``
computes every cell exactly once, after its three neighbours, and gives
the plain versions' costs, moves and path statistics bit for bit (which
``tests/test_torch_dtw.py`` holds against the JAX scan and Pallas
interpret); the path kernel's move plane, walk and row stores give the
plain version's mask and the Pallas kernel's (interpret mode) bit for
bit. Also the build key of the kernel libraries."""

import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from abnet3_tpu.ops.pallas_dtw import dtw_path_pallas
from abnet3_torch.ops import cuda_dtw
from abnet3_torch.ops.cuda_dtw import (SMEM_LIMIT, STRIP_PREFETCH,
                                       dtw_path_plain, dtw_path_stats_plain,
                                       strip_geometry)
from abnet3_torch.ops.dtw import dtw_costs, moves_from_costs
from abnet3_torch.ops.strip_schedule import (emulate_path, emulate_strip,
                                             ring_schedule)

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
    if kind == "angular":   # arccos of the cosines of random frames, / pi
        B, T1, T2 = shape
        x = rng.randn(B, T1, 7)
        y = rng.randn(B, T2, 7)
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        y /= np.linalg.norm(y, axis=-1, keepdims=True)
        cos = np.clip(np.einsum("bik,bjk->bij", x, y), -1, 1)
        return (np.arccos(cos) / np.pi).astype(np.float32)
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
    # the path kernel (move_plane): the flagship bucket, its plane of 96
    # rows of 96 bytes in shared memory after the ring
    ((32, 96, 96), 1, dict(move_plane=True, strip=4, move_pitch=96,
                           moves_in_smem=1, warp_floats=32 * 96 + 96 * 24,
                           warps=1, blocks=32)),
    # more pairs than SMs: two warps a block, rows of 32 bytes
    ((200, 32, 32), 1, dict(move_plane=True, strip=1, move_pitch=32,
                            moves_in_smem=1, warps=2, blocks=100,
                            warp_floats=40 * 32 + 32 * 8)),
    # T2 % 4 != 0: rows of whole words
    ((5, 40, 37), 1, dict(move_plane=True, strip=2, move_pitch=40,
                          moves_in_smem=1)),
    # three chunks, the plane (146 KB) in shared memory past 48 KB
    ((4, 300, 500), 1, dict(move_plane=True, chunks=4, move_pitch=500,
                            moves_in_smem=1,
                            warp_floats=40 * 128 + 300 + 300 * 125)),
    # a plane that leaves room for fewer pairs in a block
    ((1024, 300, 96), 1, dict(move_plane=True, moves_in_smem=1, warps=4,
                              blocks=256)),
    # one warp's plane past 227 KB: the global scratch, the ring and the
    # carry alone in shared memory
    ((2, 512, 512), 1, dict(move_plane=True, move_pitch=512,
                            moves_in_smem=0, warp_floats=40 * 128 + 512)),
    ((2000, 60000, 128), 1, dict(move_plane=True, moves_in_smem=0,
                                 chunks=1, warps=8,
                                 warp_floats=40 * 128)),
])
def test_strip_geometry(shape, words, expect):
    expect = dict(expect)
    plane = expect.pop("move_plane", False)
    geo = strip_geometry(*shape, carry_words=words, move_plane=plane)
    for key, value in expect.items():
        assert getattr(geo, key) == value, (key, geo)
    assert geo.ring_rows == geo.lanes + STRIP_PREFETCH
    assert geo.pitch % 4 == 0 and geo.pitch >= geo.lanes * geo.strip
    assert geo.strip in (1, 2, 4)
    assert geo.lanes <= 32 and geo.strip * 32 * geo.chunks >= shape[2]
    assert geo.blocks * geo.warps >= shape[0]
    assert geo.smem_bytes <= SMEM_LIMIT
    if not plane:
        assert geo.move_pitch == geo.moves_in_smem == 0
        return
    # rows of whole words; the plane after the ring (and the carry) keeps
    # the next warp's ring on 16 bytes
    T1, T2 = shape[1:]
    assert geo.move_pitch % 4 == 0 and geo.move_pitch >= T2
    without = strip_geometry(*shape, carry_words=words)
    plane_floats = geo.warp_floats - without.warp_floats
    assert geo.warp_floats % 4 == 0
    if geo.moves_in_smem:
        assert 4 * plane_floats >= T1 * geo.move_pitch
    else:
        assert plane_floats == 0
        assert 4 * (without.warp_floats + T1 * geo.move_pitch / 4) \
            > SMEM_LIMIT


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
    # the path kernel: the carry is the limit, a plane that does not fit
    # goes to the global scratch
    with pytest.raises(ValueError, match="shared memory"):
        cuda_dtw._check_strip_fits(2, 60000, 130, carry_words=1,
                                   move_plane=True)
    assert not cuda_dtw._check_strip_fits(2, 60000, 128, carry_words=1,
                                          move_plane=True).moves_in_smem
    assert not cuda_dtw._check_strip_fits(2, 50000, 130, carry_words=1,
                                          move_plane=True).moves_in_smem
    assert cuda_dtw._check_strip_fits(32, 96, 96, carry_words=1,
                                      move_plane=True).moves_in_smem


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


@pytest.mark.parametrize("name", ["dtw_moves", "dtw_path_stats", "dtw_path"])
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
    """All three sources include the strip core: a header edit renames
    every library; an edit of one source leaves the others' libraries
    alone; a change of the compiler flags renames every library."""
    names = ["dtw_moves", "dtw_path_stats", "dtw_path"]
    for name in names:
        assert [os.path.basename(p) for p in cuda_dtw.source_files(name)] \
            == [f"{name}.cu", "dtw_strip.cuh"]
    before = {n: cuda_dtw.library_path(n) for n in names}
    with open(csrc_copy / "dtw_path.cu", "ab") as fh:
        fh.write(b"// edited\n")
    edited = {n: cuda_dtw.library_path(n) for n in names}
    assert edited["dtw_path"] != before["dtw_path"]
    assert all(edited[n] == before[n] for n in names[:2])
    with open(csrc_copy / "dtw_strip.cuh", "ab") as fh:
        fh.write(b"// edited\n")
    header = {n: cuda_dtw.library_path(n) for n in names}
    assert all(header[n] not in (before[n], edited[n]) for n in names)
    monkeypatch.setattr(cuda_dtw, "NVCC_FLAGS",
                        cuda_dtw.NVCC_FLAGS + ["-lineinfo"])
    assert all(cuda_dtw.library_path(n) != header[n] for n in names)


# -- the path kernel: move plane, walk, row stores ---------------------------

# each strip width, T2 % 4 != 0 (4-byte row stores, a partial last strip),
# T1 != T2, one row, one column, two and three column chunks, a plane past
# 48 KB (the smoke's (4, 300, 500) at B = 1)
PATH_SHAPES = [(3, 96, 96), (3, 64, 64), (3, 32, 32), (3, 40, 72),
               (3, 50, 37), (3, 33, 100), (3, 7, 1), (3, 1, 9),
               (2, 70, 129), (2, 40, 300), (1, 300, 500)]


def _path_lengths(shape, seed=14):
    """Ragged lengths with (T1, T2), (1, T2) and (T1, 1) first."""
    B, T1, T2 = shape
    rng = np.random.RandomState(seed)
    n1 = rng.randint(1, T1 + 1, B).astype(np.int32)
    n2 = rng.randint(1, T2 + 1, B).astype(np.int32)
    n1[0], n2[0] = T1, T2
    if B > 1:
        n1[1], n2[1] = 1, T2
    if B > 2:
        n1[2], n2[2] = T1, 1
    return n1, n2


def _check_path_run(run, dist, n1, n2):
    """Every element written once; the moves in the plane at the
    kernel's addresses, bytes past the pair never stored; the walk one
    step per path cell; the mask the plain version's, bit for bit."""
    B, T1, T2 = dist.shape
    geo = strip_geometry(B, T1, T2, 1, move_plane=True)
    A = dtw_path_plain(torch.from_numpy(dist), torch.from_numpy(n1),
                       torch.from_numpy(n2)).numpy()
    assert np.array_equal(_bits(run.mask), _bits(A))
    assert (run.writes == 1).all()
    full = moves_from_costs(dtw_costs(torch.from_numpy(dist))).numpy()
    pitch, chunk = geo.move_pitch, 32 * geo.strip
    for b in range(B):
        a, c = int(n1[b]), int(n2[b])
        if not (1 <= a <= T1 and 1 <= c <= T2):
            assert not run.mask[b].any() and not run.stored[b].any()
            continue
        stored = run.stored[b].reshape(T1, pitch)
        assert (stored <= 1).all()
        # a row's bytes stored: whole strips of the pair's columns
        last = (c - 1) // chunk * chunk
        width = last + -(-(c - last) // geo.strip) * geo.strip
        assert (stored[:a, :width] == 1).all() and not stored[:, width:].any()
        assert not stored[a:].any()
        # the walk left each row's key over its first word: the moves of
        # the other columns are the full plane's (the DP flows from (0, 0))
        plane = run.plane[b].reshape(T1, pitch)
        assert np.array_equal(plane[:a, 4:c], full[b, :a, 4:c])
        assert run.walk_steps[b] == A[b].sum()
        lo, hi = run.runs[b, :a, 0], run.runs[b, :a, 1]
        assert hi[-1] == c - 1 and lo[0] == 0   # from (a-1, c-1) to (0, 0)
        assert (A[b, :a].sum(1) == hi - lo + 1).all()


@pytest.mark.parametrize("kind", ["angular", "ties"])
@pytest.mark.parametrize("shape", PATH_SHAPES, ids=str)
def test_path_emulation_gives_plain_mask(kind, shape):
    dist = _dist(kind, shape, seed=15)
    n1, n2 = _path_lengths(shape)
    _check_path_run(emulate_path(dist, n1, n2), dist, n1, n2)


@pytest.mark.parametrize("kind", ["angular", "ties"])
@pytest.mark.parametrize("shape", [(3, 96, 96), (3, 50, 37), (2, 70, 129),
                                   (3, 7, 1)], ids=str)
def test_path_emulation_matches_pallas_interpret(kind, shape):
    """The emulated kernel against the TPU kernel, run as the JAX
    package's tests run it on the CPU."""
    dist = _dist(kind, shape, seed=16)
    n1, n2 = _path_lengths(shape, seed=17)
    run = emulate_path(dist, n1, n2)
    A = np.asarray(dtw_path_pallas(jnp.asarray(dist), jnp.asarray(n1),
                                   jnp.asarray(n2), interpret=True))
    np.testing.assert_array_equal(run.mask, A)


def test_path_emulation_lengths_outside_the_plane():
    dist = _dist("angular", (6, 9, 40))
    n1 = np.array([9, 0, 10, 5, 9, 4], np.int32)
    n2 = np.array([40, 7, 7, 0, 41, 3], np.int32)
    run = emulate_path(dist, n1, n2)
    _check_path_run(run, dist, n1, n2)
    assert not run.mask[1:5].any() and run.mask[0].sum() >= 40
    assert run.walk_steps[1:5].tolist() == [0, 0, 0, 0]


def test_path_emulation_walk_that_leaves_the_plane():
    """Infinite costs in column 0 make a diagonal move out of it: the rows
    above get empty runs, as in the plain version's reverse row DP."""
    dist = _dist("uniform", (3, 12, 10), seed=18)
    dist[:, 3, 0] = np.inf
    n1 = np.array([12, 12, 7], np.int32)
    n2 = np.array([1, 10, 3], np.int32)
    run = emulate_path(dist, n1, n2)
    A = dtw_path_plain(torch.from_numpy(dist), torch.from_numpy(n1),
                       torch.from_numpy(n2)).numpy()
    assert np.array_equal(run.mask, A) and (run.writes == 1).all()
    assert run.keys[0, 11] == 1 and (run.keys[0, :11] == -1).all()
    assert run.mask[0].sum() == 1


@pytest.mark.parametrize("garbage", [1, 2, 3])
def test_path_walk_reads_no_move_past_the_pair(garbage):
    """Whatever a partial last strip stores past column n2-1, the mask
    is the same."""
    dist = _dist("ties", (3, 30, 37), seed=19)
    n1, n2 = _path_lengths((3, 30, 37))
    n2[1:] = [21, 35]      # strips of 2 columns: the last one half out
    run = emulate_path(dist, n1, n2, garbage=garbage)
    _check_path_run(run, dist, n1, n2)
