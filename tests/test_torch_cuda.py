"""The CUDA kernels against their plain versions, on a card; they skip
without one (a CUDA kernel has no CPU mode). This file imports neither
jax nor abnet3_tpu, so it also runs where they are not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

import pytest
import torch

from abnet3_torch.ops import cuda_dtw
from abnet3_torch.ops.dtw import pairwise_angular_distance


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(kind, shape, device, seed=6):
    """Angular distances of random frames, or integer costs in {0, 1, 2}
    (full of exact ties); ragged lengths including 1 and the full T."""
    B, T1, T2 = shape
    g = torch.Generator().manual_seed(seed)
    if kind == "ties":
        dist = torch.randint(0, 3, shape, generator=g).float()
    else:
        dist = pairwise_angular_distance(torch.randn(B, T1, 7, generator=g),
                                         torch.randn(B, T2, 7, generator=g))
    n1 = torch.randint(1, T1 + 1, (B,), generator=g, dtype=torch.int32)
    n2 = torch.randint(1, T2 + 1, (B,), generator=g, dtype=torch.int32)
    n1[0], n2[0] = T1, T2
    if B > 1:
        n1[1] = 1
    return dist.to(device), n1.to(device), n2.to(device)


# the flagship buckets, a non-square plane, three column chunks with the
# moves in shared memory past 48 KB, moves in the global scratch (past
# 227 KB), several pairs a block, T2 % 4 != 0 (4-byte row stores)
PATH_SHAPES = [(32, 96, 96), (64, 64, 64), (7, 40, 72), (3, 300, 500),
               (2, 512, 512), (200, 32, 32), (4, 300, 500), (5, 40, 72),
               (5, 50, 37), (3, 70, 129)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["angular", "ties"])
@pytest.mark.parametrize("shape", PATH_SHAPES)
def test_dtw_path_kernel_matches_plain(cuda_device, kind, shape):
    dist, n1, n2 = _inputs(kind, shape, cuda_device)
    before = cuda_dtw.dtw_path_cuda.launches
    A = cuda_dtw.dtw_path_cuda(dist, n1, n2)
    assert cuda_dtw.dtw_path_cuda.launches == before + 1
    assert torch.equal(A, cuda_dtw.dtw_path_plain(dist, n1, n2))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(6, 20, 40), (6, 20, 37), (6, 300, 200)])
def test_dtw_path_kernel_lengths_outside_the_plane(cuda_device, shape):
    """Lengths 0 and T+1 give zero planes; the other pairs their paths."""
    dist, n1, n2 = _inputs("angular", shape, cuda_device)
    n1[2], n2[3], n1[4], n2[5] = 0, 0, shape[1] + 1, shape[2] + 1
    A = cuda_dtw.dtw_path_cuda(dist, n1, n2)
    assert torch.equal(A, cuda_dtw.dtw_path_plain(dist, n1, n2))
    assert not A[2:].any() and A[0].sum() >= max(shape[1:])


@pytest.mark.cuda
def test_dispatcher_launches_kernel_on_card(cuda_device):
    from abnet3_torch.ops.dtw import dtw_path_from_dist
    dist, n1, n2 = _inputs("angular", (4, 16, 16), cuda_device)
    before = cuda_dtw.dtw_path_cuda.launches
    A = dtw_path_from_dist(dist, n1, n2)
    assert cuda_dtw.dtw_path_cuda.launches == before + 1
    assert torch.equal(A, cuda_dtw.dtw_path_plain(dist, n1, n2))


def _stats_inputs(kind, layout, shape, device, seed=7):
    """Rows-layout (T1, B, T2) or batched (B, T1, T2) distances, angular
    or tie-heavy integers, ragged lengths including 1 and the full T."""
    T1, B, T2 = shape if layout == "rows" else (shape[1], shape[0],
                                                 shape[2])
    g = torch.Generator().manual_seed(seed)
    if kind == "ties":
        dist = torch.randint(0, 3, (B, T1, T2), generator=g).float()
    else:
        dist = pairwise_angular_distance(torch.randn(B, T1, 9, generator=g),
                                         torch.randn(B, T2, 9, generator=g))
    if layout == "rows":
        dist = dist.permute(1, 0, 2).contiguous()
    n1 = torch.randint(1, T1 + 1, (B,), generator=g, dtype=torch.int32)
    n2 = torch.randint(1, T2 + 1, (B,), generator=g, dtype=torch.int32)
    n1[0], n2[0] = T1, T2
    if B > 2:
        n1[1], n2[2] = 1, 1
    return dist.to(device), n1.to(device), n2.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["angular", "ties"])
@pytest.mark.parametrize("layout,shape", [
    ("rows", (96, 256, 96)), ("rows", (96, 64, 40)), ("rows", (33, 16, 65)),
    ("rows", (300, 8, 200)), ("batch", (64, 96, 96)),
    # T2 not a multiple of 32 or of 4; one pair; one pair past 8 blocks'
    # worth; each strip width (1, 2 and 4: T2 = 32, 64, 96, 128); the
    # first shape past the widest strip (two column chunks); a wide
    # batched plane
    ("rows", (50, 16, 37)), ("rows", (33, 8, 100)), ("batch", (16, 50, 37)),
    ("batch", (1, 40, 96)), ("rows", (40, 1, 96)), ("rows", (24, 1025, 32)),
    ("rows", (40, 64, 64)), ("rows", (40, 64, 128)), ("rows", (40, 8, 129)),
    ("batch", (4, 70, 300))])
def test_dtw_path_stats_kernel_matches_plain(cuda_device, kind, layout,
                                             shape):
    """Bit-exact: plen and psum equal."""
    dist, n1, n2 = _stats_inputs(kind, layout, shape, cuda_device)
    rows = layout == "rows"
    psum_p, plen_p = cuda_dtw.dtw_path_stats_plain(
        dist.permute(1, 0, 2) if rows else dist, n1, n2)
    before = cuda_dtw.dtw_path_stats_cuda.launches
    psum, plen = cuda_dtw.dtw_path_stats_cuda(dist, n1, n2, rows=rows)
    torch.cuda.synchronize()
    assert cuda_dtw.dtw_path_stats_cuda.launches == before + 1
    assert torch.equal(plen, plen_p)
    assert torch.equal(psum, psum_p)


@pytest.mark.cuda
@pytest.mark.parametrize("layout,shape", [
    ("rows", (96, 64, 97)), ("batch", (64, 96, 97)), ("rows", (40, 8, 130)),
    ("batch", (8, 50, 38))])
def test_dtw_path_stats_kernel_reads_a_misaligned_view(cuda_device, layout,
                                                       shape):
    """``dist[..., 1:]``: base and row stride off the 16-byte grid, read
    in place on the kernel's 4-byte path, with the same bits."""
    full, n1, n2 = _stats_inputs("angular", layout, shape, cuda_device)
    dist = full[..., 1:]
    n2 = torch.clamp(n2, max=dist.shape[2])
    assert dist.data_ptr() % 16 != 0 and not dist.is_contiguous()
    rows = layout == "rows"
    psum_p, plen_p = cuda_dtw.dtw_path_stats_plain(
        dist.permute(1, 0, 2) if rows else dist, n1, n2)
    psum, plen = cuda_dtw.dtw_path_stats_cuda(dist, n1, n2, rows=rows)
    torch.cuda.synchronize()
    assert torch.equal(plen, plen_p)
    assert torch.equal(psum, psum_p)
    # and the aligned copy of the same cells
    psum_c, plen_c = cuda_dtw.dtw_path_stats_cuda(dist.contiguous(), n1, n2,
                                                  rows=rows)
    assert torch.equal(plen, plen_c) and torch.equal(psum, psum_c)


@pytest.mark.cuda
def test_dtw_path_stats_kernel_lengths_outside_the_plane(cuda_device):
    dist, n1, n2 = _stats_inputs("angular", "batch", (6, 20, 40),
                                 cuda_device)
    n1[3], n2[4], n1[5] = 0, 41, 21
    psum, plen = cuda_dtw.dtw_path_stats_cuda(dist, n1, n2)
    psum_p, plen_p = cuda_dtw.dtw_path_stats_plain(dist, n1, n2)
    assert torch.equal(psum, psum_p) and torch.equal(plen, plen_p)
    assert psum[3:].tolist() == [0, 0, 0] and plen[3:].tolist() == [0, 0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (1024, 96, 96), (32, 128, 128), (64, 96, 96), (1025, 50, 37),
    (1, 64, 100), (4, 70, 129), (4, 1024, 1024), (2000, 9000, 200),
    (200, 32, 32), (4, 300, 500), (2, 512, 512), (32, 2000, 96)])
def test_strip_geometry_mirrors_the_launch_functions(cuda_device, shape):
    """The Python mirror against the C functions' own choice."""
    import ctypes
    out = (ctypes.c_int * len(cuda_dtw.StripGeometry._fields))()
    for name, fn, words, plane in (
            ("dtw_moves", "dtw_moves_geometry", 1, False),
            ("dtw_path_stats", "dtw_path_stats_geometry", 2, False),
            ("dtw_path", "dtw_path_geometry", 1, True)):
        getattr(cuda_dtw._lib(name), fn)(*shape, out)
        assert tuple(out) == tuple(cuda_dtw.strip_geometry(*shape, words,
                                                           plane))


@pytest.mark.cuda
def test_stats_dispatchers_launch_kernel_on_card(cuda_device):
    from abnet3_torch.ops.dtw import dtw_path_stats, dtw_path_stats_rows
    dist, n1, n2 = _stats_inputs("angular", "batch", (8, 24, 20),
                                 cuda_device)
    before = cuda_dtw.dtw_path_stats_cuda.launches
    a = dtw_path_stats(dist, n1, n2)
    b = dtw_path_stats_rows(dist.permute(1, 0, 2), n1, n2)
    assert cuda_dtw.dtw_path_stats_cuda.launches == before + 2
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# the buckets of the gather path, non-square planes, a long bucket; then
# T2 not a multiple of 32 or of 4, one pair, more pairs than 8 blocks'
# worth, each strip width (1, 2 and 4: T2 = 32, 64, 96, 128), the first
# shape past the widest strip (two column chunks) and a ragged last chunk
FORWARD_SHAPES = [(32, 128, 128), (64, 96, 96), (7, 40, 72), (5, 72, 40),
                  (2, 1024, 1024), (5, 50, 37), (3, 33, 100), (1, 128, 128),
                  (1025, 16, 32), (4, 20, 64), (2, 70, 129), (3, 40, 301)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["angular", "ties"])
@pytest.mark.parametrize("shape", FORWARD_SHAPES)
def test_dtw_moves_kernel_matches_plain(cuda_device, kind, shape):
    """int8 moves bit-equal; the walk of the moves covers exactly the
    path kernel's mask."""
    from abnet3_torch.ops.dtw import walk_moves
    dist, n1, n2 = _inputs(kind, shape, cuda_device)
    before = cuda_dtw.dtw_moves_cuda.launches
    mv = cuda_dtw.dtw_moves_cuda(dist)
    torch.cuda.synchronize()
    assert cuda_dtw.dtw_moves_cuda.launches == before + 1
    assert mv.dtype == torch.int8
    assert torch.equal(mv, cuda_dtw.dtw_moves_plain(dist))
    p1, p2, plen = walk_moves(mv, n1, n2)
    A = cuda_dtw.dtw_path_cuda(dist, n1, n2)
    assert torch.equal(plen, A.sum((1, 2)).long())
    steps = torch.arange(p1.shape[1], device=cuda_device)[None, :]
    rows = torch.arange(p1.shape[0], device=cuda_device)[:, None]
    on_path = A[rows, p1, p2]
    assert bool((on_path[steps < plen[:, None]] == 1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["angular", "ties"])
@pytest.mark.parametrize("shape", FORWARD_SHAPES)
def test_dtw_costs_kernel_matches_plain(cuda_device, kind, shape):
    """The cost tensor bit-equal (max difference 0.0)."""
    dist, _, _ = _inputs(kind, shape, cuda_device)
    before = cuda_dtw.dtw_costs_cuda.launches
    D = cuda_dtw.dtw_costs_cuda(dist)
    torch.cuda.synchronize()
    assert cuda_dtw.dtw_costs_cuda.launches == before + 1
    assert torch.equal(D, cuda_dtw.dtw_costs_plain(dist))


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", ["dtw_moves_cuda", "dtw_costs_cuda"])
@pytest.mark.parametrize("shape", [(0, 16, 16), (3, 0, 16), (3, 16, 0)])
def test_forward_kernels_count_no_launch_on_empty_plane(cuda_device, wrapper,
                                                        shape):
    fn = getattr(cuda_dtw, wrapper)
    before = fn.launches
    out = fn(torch.zeros(shape, device=cuda_device))
    assert tuple(out.shape) == shape
    assert fn.launches == before


@pytest.mark.cuda
def test_align_dispatcher_launches_move_kernel_on_card(cuda_device):
    from abnet3_torch.ops.dtw import dtw_align_from_dist
    dist, n1, n2 = _inputs("angular", (6, 20, 28), cuda_device)
    before = cuda_dtw.dtw_moves_cuda.launches
    card = dtw_align_from_dist(dist, n1, n2)
    assert cuda_dtw.dtw_moves_cuda.launches == before + 1
    cpu = dtw_align_from_dist(dist.cpu(), n1.cpu(), n2.cpu())
    for a, b in zip(card, cpu):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["fbanks", "mfcc"])
@pytest.mark.parametrize("deltas", [False, True])
def test_front_end_on_the_card_matches_the_cpu(cuda_device, method, deltas):
    """The front end (cuFFT, full-float32 matmuls) on the card against the
    same function on CPU tensors: within atol 1e-3 (TF32 would be far
    outside it)."""
    from abnet3_torch.ops.dsp import spectral_frames_batch
    g = torch.Generator().manual_seed(9)
    wavs = (torch.randn(4, 32000, generator=g) * 3000).to(torch.int16)
    wavs[1, 8000:16000] = 0
    kw = dict(method=method, nfilt=40, deltas=deltas, deltasdeltas=deltas)
    card = spectral_frames_batch(wavs.to(cuda_device), 16000, **kw)
    cpu = spectral_frames_batch(wavs, 16000, **kw)
    assert card.device.type == "cuda" and card.shape == cpu.shape
    assert float((card.cpu() - cpu).abs().max()) <= 1e-3
