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
    n1[1] = 1
    return dist.to(device), n1.to(device), n2.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["angular", "ties"])
@pytest.mark.parametrize("shape", [(32, 96, 96), (64, 64, 64), (7, 40, 72),
                                   (3, 300, 500), (2, 512, 512)])
def test_dtw_path_kernel_matches_plain(cuda_device, kind, shape):
    dist, n1, n2 = _inputs(kind, shape, cuda_device)
    before = cuda_dtw.dtw_path_cuda.launches
    A = cuda_dtw.dtw_path_cuda(dist, n1, n2)
    assert cuda_dtw.dtw_path_cuda.launches == before + 1
    assert torch.equal(A, cuda_dtw.dtw_path_plain(dist, n1, n2))


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
    n1[1], n2[2] = 1, 1
    return dist.to(device), n1.to(device), n2.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["angular", "ties"])
@pytest.mark.parametrize("layout,shape", [
    ("rows", (96, 256, 96)), ("rows", (96, 64, 40)), ("rows", (33, 16, 65)),
    ("rows", (300, 8, 200)), ("batch", (64, 96, 96))])
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


FORWARD_SHAPES = [(32, 128, 128), (64, 96, 96), (7, 40, 72), (5, 72, 40),
                  (2, 1024, 1024)]


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
