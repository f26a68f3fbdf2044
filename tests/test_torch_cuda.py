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
    """int8 moves bit-equal; the walk of the moves, by the kernel and by
    the plain loop alike, covers exactly the path kernel's mask."""
    from abnet3_torch.ops.dtw import walk_moves, walk_moves_plain
    dist, n1, n2 = _inputs(kind, shape, cuda_device)
    before = cuda_dtw.dtw_moves_cuda.launches
    mv = cuda_dtw.dtw_moves_cuda(dist)
    torch.cuda.synchronize()
    assert cuda_dtw.dtw_moves_cuda.launches == before + 1
    assert mv.dtype == torch.int8
    assert torch.equal(mv, cuda_dtw.dtw_moves_plain(dist))
    p1, p2, plen = walk_moves(mv, n1, n2)
    _assert_walks_equal((p1, p2, plen), walk_moves_plain(mv, n1, n2))
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


def _assert_walks_equal(got, want):
    """(path1, path2, path_len) equal bit for bit, dtypes included."""
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def _walk_inputs(kind, shape, device, seed=8):
    """A move plane and ragged lengths (the full T first, then 1): the
    move kernel's planes of angular or tie-heavy costs, or uniformly
    random codes 0-3, which clamp at row and column 0 and may stay put
    (walks that never reach the origin)."""
    dist, n1, n2 = _inputs("ties" if kind == "ties" else "angular", shape,
                           device, seed)
    if kind == "codes":
        g = torch.Generator().manual_seed(seed)
        mv = torch.randint(0, 4, shape, generator=g).to(torch.int8)
        return mv.to(device), n1, n2
    return cuda_dtw.dtw_moves_cuda(dist), n1, n2


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["angular", "ties", "codes"])
@pytest.mark.parametrize("shape", FORWARD_SHAPES)
def test_walk_kernel_matches_plain(cuda_device, kind, shape):
    """The walk kernel against the plain loop, bit for bit, one launch a
    call; (2, 1024, 1024) walks from global memory."""
    from abnet3_torch.ops.dtw import walk_moves_plain
    mv, n1, n2 = _walk_inputs(kind, shape, cuda_device)
    before = cuda_dtw.walk_moves_cuda.launches
    got = cuda_dtw.walk_moves_cuda(mv, n1, n2)
    torch.cuda.synchronize()
    assert cuda_dtw.walk_moves_cuda.launches == before + 1
    assert got[0].dtype == torch.int64
    _assert_walks_equal(got, walk_moves_plain(mv, n1, n2))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["angular", "codes"])
@pytest.mark.parametrize("shape", [(4, 128, 128), (4, 40, 72), (4, 33, 1),
                                   (4, 1, 20), (4, 1024, 1024)])
def test_walk_kernel_lengths_at_1_and_T(cuda_device, kind, shape):
    """Each pair of lengths (1, 1), (1, T2), (T1, 1) and (T1, T2)."""
    from abnet3_torch.ops.dtw import walk_moves_plain
    mv, _, _ = _walk_inputs(kind, shape, cuda_device)
    T1, T2 = shape[1:]
    n1 = torch.tensor([1, 1, T1, T1], dtype=torch.int32, device=cuda_device)
    n2 = torch.tensor([1, T2, 1, T2], dtype=torch.int32, device=cuda_device)
    got = cuda_dtw.walk_moves_cuda(mv, n1, n2)
    torch.cuda.synchronize()
    _assert_walks_equal(got, walk_moves_plain(mv, n1, n2))
    assert int(got[2][0]) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["angular", "codes"])
@pytest.mark.parametrize("shape", [(3, 300, 500), (2, 470, 470),
                                   (2, 480, 480), (2, 129, 2000)])
def test_walk_kernel_around_the_shared_memory_budget(cuda_device, kind,
                                                     shape):
    """Planes staged in shared memory past 48 KB ((300, 500), (470,
    470): rows and trail within 227 KB) and planes walked in place from
    global memory ((480, 480), (129, 2000): past it)."""
    from abnet3_torch.ops.dtw import walk_moves_plain
    mv, n1, n2 = _walk_inputs(kind, shape, cuda_device)
    got = cuda_dtw.walk_moves_cuda(mv, n1, n2)
    torch.cuda.synchronize()
    _assert_walks_equal(got, walk_moves_plain(mv, n1, n2))


@pytest.mark.cuda
def test_walk_dispatcher_launches_kernel_on_card(cuda_device, monkeypatch):
    """walk_moves on a CUDA tensor is one launch of the kernel and never
    enters the plain loop, whatever the lengths' dtype and device; so is
    the walk of dtw_align_from_dist."""
    from abnet3_torch.ops import dtw
    dist, n1, n2 = _inputs("angular", (6, 20, 28), cuda_device)
    mv = cuda_dtw.dtw_moves_cuda(dist)
    want = dtw.walk_moves_plain(mv, n1, n2)

    def plain(*args):
        raise AssertionError("the plain loop ran on a CUDA tensor")
    monkeypatch.setattr(dtw, "walk_moves_plain", plain)
    before = cuda_dtw.walk_moves_cuda.launches
    _assert_walks_equal(dtw.walk_moves(mv, n1.long(), n2.cpu()), want)
    assert cuda_dtw.walk_moves_cuda.launches == before + 1
    _assert_walks_equal(dtw.dtw_align_from_dist(dist, n1, n2), want)
    assert cuda_dtw.walk_moves_cuda.launches == before + 2


@pytest.mark.cuda
def test_walk_kernel_counts_no_launch_on_empty_batch(cuda_device):
    before = cuda_dtw.walk_moves_cuda.launches
    n = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    p1, p2, plen = cuda_dtw.walk_moves_cuda(
        torch.zeros((0, 16, 8), dtype=torch.int8, device=cuda_device), n, n)
    assert tuple(p1.shape) == (0, 23) and tuple(plen.shape) == (0,)
    assert cuda_dtw.walk_moves_cuda.launches == before


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


def _scores_equal(a, b):
    assert (a["error"], a["n_cells"], a["n_triplets"]) == \
        (b["error"], b["n_cells"], b["n_triplets"])
    assert a["cells"] == b["cells"]


def _labels(n, n_classes, n_spk, seed):
    g = torch.Generator().manual_seed(seed)
    return ([f"c{int(v)}" for v in torch.randint(0, n_classes, (n,),
                                                 generator=g)],
            [f"s{int(v)}" for v in torch.randint(0, n_spk, (n,),
                                                 generator=g)])


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [None, 32])
def test_device_scorer_on_the_card_equals_the_cpu(cuda_device, rows):
    """``distance_matrix(device_out=True)``'s u16 matrix on the card and a
    float32 host upload (row blocks of 32 with chunk=8: anchors padded
    outside their block, the clamped gather), each scored on the card
    and on the CPU: bit-identical errors and cells, equal to the host
    scorer's."""
    import numpy as np

    from abnet3_torch.eval.abx import abx_error, distance_matrix
    from abnet3_torch.eval.abx_device import abx_error_device, upload_matrix
    from abnet3_torch.ops.bank import TokenBank
    g = torch.Generator().manual_seed(10)
    n = 100
    feats = {i: torch.randn(int(torch.randint(5, 30, (1,), generator=g)),
                            12, generator=g).numpy() for i in range(n)}
    D, dm = distance_matrix(TokenBank(feats, device=cuda_device),
                            batch_size=32, strategy="tiles", device_out=True,
                            device_rows_per_block=rows)
    assert dm.device.type == cuda_device.type
    assert dm.blocks[0].dtype == torch.int16
    assert len(dm.blocks) == (1 if rows is None else 4)
    labels, speakers = _labels(n, 9, 4, seed=11)
    cpu = upload_matrix(dm.numpy(), rows_per_block=rows, device="cpu")
    for task in ("across", "within"):
        kw = dict(task=task, return_cells=True)
        card = abx_error_device(dm, labels, speakers, **kw)
        _scores_equal(card, abx_error_device(cpu, labels, speakers, **kw))
        _scores_equal(card, abx_error(D, labels, speakers, **kw))

    q = (torch.randint(0, 24, (n, n), generator=g).float() / 24).numpy()
    Dq = np.triu(q, 1) + np.triu(q, 1).T
    for task in ("across", "within"):
        kw = dict(task=task, return_cells=True, chunk=8)
        card = abx_error_device(upload_matrix(Dq, rows_per_block=rows,
                                              device=cuda_device),
                                labels, speakers, **kw)
        _scores_equal(card, abx_error_device(Dq, labels, speakers,
                                             device="cpu", **kw))
        kw.pop("chunk")
        _scores_equal(card, abx_error(Dq, labels, speakers, **kw))


def _token_feats(n, dim, seed):
    g = torch.Generator().manual_seed(seed)
    return {i: torch.randn(int(torch.randint(4, 40, (1,), generator=g)),
                           dim, generator=g).numpy() for i in range(n)}


def _two_nets(device):
    """A network on the card and a CPU network with its weights."""
    from abnet3_torch.models.siamese import SiameseNetwork
    from abnet3_torch.weights import load_jax_numpy, to_jax_numpy
    kw = dict(input_dim=12, num_hidden_layers=1, hidden_dim=32,
              output_dim=8, p_dropout=0.0, activation_layer="sigmoid",
              batch_norm=True)
    card = SiameseNetwork(device=device, **kw)
    card.ensure_init(0)
    cpu = SiameseNetwork(device="cpu", **kw)
    load_jax_numpy(cpu, *to_jax_numpy(card))
    return card, cpu


@pytest.mark.cuda
@pytest.mark.parametrize("matrix", [True, False])
def test_mixed_bank_step_on_the_card_matches_the_cpu(cuda_device, matrix):
    """The mixed same/diff bank step (``make_pair_train_step``) with a tcl
    group, on the card against the CPU path: eval and train losses
    within rtol 1e-4, one launch of the path kernel (matrix mode) or of
    the move kernel (gather mode) per step."""
    from abnet3_torch.loss import coscos2
    from abnet3_torch.ops.bank import TokenBank, upload_rows
    from abnet3_torch.parallel import make_pair_train_step
    from abnet3_torch.trainer import build_optimizer
    feats = _token_feats(40, 12, seed=12)
    g = torch.Generator().manual_seed(13)
    table = torch.randn(300, 12, generator=g).numpy()
    B = 16
    ids = torch.randperm(40, generator=g)[:2 * B]
    y = torch.where(torch.arange(B) % 2 == 0, 1.0, -1.0)
    w = torch.ones(B)
    w[-1] = 0.0
    a = torch.randint(0, 260, (6,), generator=g)
    ti1 = a.repeat_interleave(5)
    ti2 = ti1 + torch.tensor([1, 15, 20, 25, 30]).repeat(6)
    ty = torch.tensor([1.0, -1.0, -1.0, -1.0, -1.0]).repeat(6)
    args = (ids[:B], ids[B:], y, w, ti1, ti2, ty, torch.ones(30))
    out = {}
    card_net, cpu_net = _two_nets(cuda_device)
    for dev, net in ((cuda_device, card_net), ("cpu", cpu_net)):
        opt = build_optimizer("adadelta", net.parameters(), 0.1)
        step, ev = make_pair_train_step(
            net, coscos2(), opt, TokenBank(feats, device=dev),
            max_frames=32, matrix_loss=matrix,
            frame_bank=upload_rows(table, device=dev), tcl=0.2)
        dargs = [t.to(dev) for t in args]
        kernel = (cuda_dtw.dtw_path_cuda if matrix
                  else cuda_dtw.dtw_moves_cuda)
        before = kernel.launches
        out[str(dev)] = (float(ev(*dargs)), float(step(*dargs)))
        if dev != "cpu":
            assert kernel.launches == before + 2
    card, cpu = out[str(cuda_device)], out["cpu"]
    for x, y_ in zip(card, cpu):
        assert abs(x - y_) <= 1e-4 * abs(y_)


def _split_step_card_cpu(cuda_device, make_nets, loss, extra_labels,
                         matrix, kernel, align_different_words=False):
    """Eval and train losses of one split bank step on the card and on
    the CPU from the same weights and batch, and the card's launches of
    ``kernel`` (two: the eval step and the train step)."""
    from abnet3_torch.ops.bank import TokenBank
    from abnet3_torch.parallel import make_split_pair_train_step
    from abnet3_torch.trainer import build_optimizer
    feats = _token_feats(40, 12, seed=21)
    g = torch.Generator().manual_seed(22)
    ids = torch.randperm(40, generator=g)
    Bs, Bd = 10, 8
    ws, wd = torch.ones(Bs), torch.ones(Bd)
    ws[-1] = wd[-1] = 0.0
    args = (ids[:Bs], ids[Bs:2 * Bs], ws, ids[2 * Bs:2 * Bs + Bd],
            ids[2 * Bs + Bd:2 * Bs + 2 * Bd], wd)
    if extra_labels:
        args += (torch.where(torch.rand(Bs, generator=g) < 0.5, 1.0, -1.0),
                 torch.where(torch.rand(Bd, generator=g) < 0.5, 1.0, -1.0))
    out, launches = {}, None
    for dev, net in zip((cuda_device, "cpu"), make_nets(cuda_device)):
        opt = build_optimizer("adadelta", net.parameters(), 0.1)
        step, ev = make_split_pair_train_step(
            net, loss, opt, TokenBank(feats, device=dev), max_frames=64,
            matrix_loss=matrix, extra_labels=extra_labels,
            align_different_words=align_different_words)
        dargs = [t.to(dev) for t in args]
        before = kernel.launches
        out[str(dev)] = (float(ev(*dargs)), float(step(*dargs)))
        if dev != "cpu":
            launches = kernel.launches - before
    return out[str(cuda_device)], out["cpu"], launches


def _multitask_nets(device):
    """A multitask network on the card and a CPU one with its weights."""
    from abnet3_torch.models.siamese import SiameseMultitaskNetwork
    from abnet3_torch.weights import load_jax_numpy, to_jax_numpy
    kw = dict(input_dim=12, num_hidden_layers_shared=1,
              num_hidden_layers_spk=1, num_hidden_layers_phn=1,
              hidden_dim=32, output_dim=8, p_dropout=0.0,
              activation_layer="sigmoid", batch_norm=True)
    card = SiameseMultitaskNetwork(device=device, **kw)
    card.ensure_init(0)
    cpu = SiameseMultitaskNetwork(device="cpu", **kw)
    load_jax_numpy(cpu, *to_jax_numpy(card))
    return card, cpu


@pytest.mark.cuda
@pytest.mark.parametrize("matrix", [True, False])
def test_multitask_split_step_on_the_card_matches_the_cpu(cuda_device,
                                                          matrix):
    """The multitask split step (speaker labels, weighted_loss_multi of
    coscos2 and cosmargin) on the card against the CPU path: eval and
    train losses within rtol 1e-4, one path-kernel (matrix mode) or
    move-kernel (gather mode) launch a step."""
    from abnet3_torch.loss import coscos2, cosmargin, weighted_loss_multi
    loss = weighted_loss_multi(weight=0.5, loss_spk=coscos2(),
                               loss_phn=cosmargin(margin=0.4))
    kernel = cuda_dtw.dtw_path_cuda if matrix else cuda_dtw.dtw_moves_cuda
    card, cpu, launches = _split_step_card_cpu(
        cuda_device, _multitask_nets, loss, True, matrix, kernel)
    assert launches == 2
    for x, y_ in zip(card, cpu):
        assert abs(x - y_) <= 1e-4 * abs(y_)


@pytest.mark.cuda
@pytest.mark.parametrize("align_different_words", [False, True])
def test_kl_matrix_step_on_the_card_matches_the_cpu(cuda_device,
                                                    align_different_words):
    """Single-task KLLoss on a softmax SiameseNetwork through the split
    step in matrix mode (cells with a stat axis), truncate and stretch,
    on the card against the CPU: losses within rtol 1e-4, one path-kernel
    launch a step."""
    from abnet3_torch.loss import KLLoss
    from abnet3_torch.models.siamese import SiameseNetwork
    from abnet3_torch.weights import load_jax_numpy, to_jax_numpy

    def nets(device):
        kw = dict(input_dim=12, num_hidden_layers=1, hidden_dim=32,
                  output_dim=8, p_dropout=0.0, activation_layer="softmax",
                  batch_norm=True)
        card = SiameseNetwork(device=device, **kw)
        card.ensure_init(0)
        cpu = SiameseNetwork(device="cpu", **kw)
        load_jax_numpy(cpu, *to_jax_numpy(card))
        return card, cpu

    card, cpu, launches = _split_step_card_cpu(
        cuda_device, nets, KLLoss(margin=1.0), False, True,
        cuda_dtw.dtw_path_cuda, align_different_words)
    assert launches == 2
    for x, y_ in zip(card, cpu):
        assert abs(x - y_) <= 1e-4 * abs(y_)


@pytest.mark.cuda
def test_load_all_frames_on_the_card_matches_the_cpu(cuda_device):
    """``FramesDataLoader.load_all_frames`` with the move kernel on the
    card against the plain version on the CPU: the same table and
    labels, the aligned frames' summed angular distance (the DTW costs)
    within rtol 1e-4, one launch per chunk of same pairs."""
    import numpy as np

    from abnet3_torch.dataloader import FramesDataLoader
    from abnet3_torch.utils import Features_Accessor, cosine_distance
    g = torch.Generator().manual_seed(14)
    feats = {f"f{i}": torch.randn(200, 12, generator=g).numpy()
             for i in range(4)}
    times = {k: np.arange(200) * 0.01 + 0.0025 for k in feats}
    rng = np.random.RandomState(15)
    pairs = []
    for k in range(40):
        f1, f2 = rng.randint(4, size=2)
        s1, s2 = rng.randint(0, 150, size=2) * 0.01
        n1, n2 = rng.randint(5, 40, size=2) * 0.01
        pairs.append((f"f{f1}", s1, s1 + n1, f"f{f2}", s2, s2 + n2,
                      "same" if k % 3 else "diff"))
    out = {}
    for dev in (cuda_device, "cpu"):
        dl = FramesDataLoader(None, None, align_chunk=8, device=dev)
        dl.features = Features_Accessor(times, feats)
        dl._rng = np.random.RandomState(0)
        before = cuda_dtw.dtw_moves_cuda.launches
        table, frames = dl.load_all_frames(pairs)
        out[str(dev)] = (table, frames,
                         cuda_dtw.dtw_moves_cuda.launches - before)
    (t_card, f_card, n_card), (t_cpu, f_cpu, n_cpu) = (
        out[str(cuda_device)], out["cpu"])
    n_same = sum(p[6] == "same" for p in pairs)
    assert (n_card, n_cpu) == (-(-n_same // 8), 0)
    np.testing.assert_array_equal(t_card, t_cpu)
    assert sorted(f_card[:, 2].tolist()) == sorted(f_cpu[:, 2].tolist())

    def cost(table, frames):
        same = frames[frames[:, 2] > 0]
        return sum(float(cosine_distance(table[a:a + 1],
                                         table[b:b + 1])[0, 0])
                   for a, b, _ in same)
    c_card, c_cpu = cost(t_card, f_card), cost(t_cpu, f_cpu)
    assert abs(c_card - c_cpu) <= 1e-4 * c_cpu


def _sampler_inventory(n_types=12, n_spk=4, per=6, seed=16):
    """descr and P(type, speaker) of a random inventory, through the
    port's sampler (the flagship's log sampling)."""
    import random as pyrandom

    from abnet3_torch.sampler import SamplerClusterSiamese
    rng = pyrandom.Random(seed)
    clusters = [[[f"f{rng.randrange(8)}", 0.1 * k, 0.1 * k + 0.2]
                 for k in range(per)] for _ in range(n_types)]
    spk = {f"f{i}": f"s{i % n_spk}" for i in range(8)}
    sampler = SamplerClusterSiamese()
    descr = sampler.analyze_clusters(clusters, spk)
    return descr, sampler.type_speaker_sampling_p(descr, "log", "log")


@pytest.mark.cuda
def test_sampler_draws_on_the_card(cuda_device):
    """The device pair sampler draws on the card: 200 batches pass the
    chi-square test per configuration (p > 1e-3), one generator seed
    gives identical ids, and the draw of given raw numbers equals the
    CPU's exactly."""
    from abnet3_torch.ops.sampling import (DevicePairSampler,
                                           chi_square_by_config)
    descr, proba = _sampler_inventory()
    card = DevicePairSampler(descr, proba, batch_size=64,
                             device=cuda_device)
    cpu = DevicePairSampler(descr, proba, batch_size=64, device="cpu")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    batches = [card.sample(gen) for _ in range(200)]
    assert batches[0][0].is_cuda
    for r in chi_square_by_config(card, batches):
        assert r["p"] > 1e-3, r
    a, b = (card.sample(torch.Generator(device=cuda_device).manual_seed(7))
            for _ in range(2))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    raws = card.raws(torch.Generator(device=cuda_device).manual_seed(8))
    on_card = card._draw_from(raws)
    on_cpu = cpu._draw_from([tuple(t.cpu() for t in r) for r in raws])
    for x, y in zip(on_card, on_cpu):
        assert torch.equal(x.cpu(), y)


class _GivenDraw:
    """A stand-in sampler that hands out one fixed draw."""

    def __init__(self, draw):
        self.draw = draw

    def sample(self, generator, with_speakers=False):
        return self.draw


@pytest.mark.cuda
@pytest.mark.parametrize("matrix", [True, False])
def test_sampled_step_on_the_card_matches_the_cpu(cuda_device, matrix):
    """One sampled train step (K=1) on the card against the CPU, on the
    same ids and weights: losses within rtol 1e-4, one launch of the
    path kernel (matrix mode) or the move kernel (gather mode); a K=4
    call draws on the card with no host sync."""
    from abnet3_torch.loss import coscos2
    from abnet3_torch.ops.bank import TokenBank
    from abnet3_torch.ops.sampling import DevicePairSampler
    from abnet3_torch.parallel import make_sampled_train_step
    from abnet3_torch.trainer import build_optimizer
    descr, proba = _sampler_inventory()
    feats = _token_feats(len(descr["tokens"]), 12, seed=17)
    card_net, cpu_net = _two_nets(cuda_device)
    sampler = DevicePairSampler(descr, proba, batch_size=32,
                                device=cuda_device)
    draw = sampler.sample(torch.Generator(device=cuda_device).manual_seed(1))
    kernel = cuda_dtw.dtw_path_cuda if matrix else cuda_dtw.dtw_moves_cuda
    out = {}
    for dev, net in ((cuda_device, card_net), ("cpu", cpu_net)):
        opt = build_optimizer("adadelta", net.parameters(), 0.1)
        bank = TokenBank(feats, device=dev)
        step = make_sampled_train_step(
            net, coscos2(), opt, bank,
            _GivenDraw(tuple(t.to(dev) for t in draw)), matrix_loss=matrix)
        before = kernel.launches
        out[str(dev)] = float(step(None))
        if dev != "cpu":
            assert kernel.launches == before + 1
            call = make_sampled_train_step(net, coscos2(), opt, bank,
                                           sampler, steps_per_call=4,
                                           matrix_loss=matrix)
            gen = torch.Generator(device=cuda_device).manual_seed(2)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                value = call(gen)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert torch.isfinite(value)
    assert abs(out[str(cuda_device)] - out["cpu"]) <= 1e-4 * abs(out["cpu"])


@pytest.mark.cuda
def test_lbfgs_step_on_the_card_matches_the_cpu(cuda_device):
    """One LBFGS step of the split bank matrix step on the card against
    the CPU: the loss within rtol 1e-4, the parameters after it within
    atol 1e-5, the same linesearch steps, one path-kernel launch."""
    from abnet3_torch.loss import coscos2
    from abnet3_torch.ops.bank import TokenBank
    from abnet3_torch.parallel import make_split_pair_train_step
    from abnet3_torch.trainer import build_optimizer
    from abnet3_torch.weights import to_jax_numpy
    feats = _token_feats(40, 12, seed=18)
    g = torch.Generator().manual_seed(19)
    ids = torch.randperm(40, generator=g)
    args = (ids[:8], ids[8:16], torch.ones(8), ids[16:24], ids[24:32],
            torch.ones(8))
    out = {}
    card_net, cpu_net = _two_nets(cuda_device)
    for dev, net in ((cuda_device, card_net), ("cpu", cpu_net)):
        opt = build_optimizer("LBFGS", net.parameters(), 1.0)
        step, _ = make_split_pair_train_step(
            net, coscos2(), opt, TokenBank(feats, device=dev), max_frames=32)
        before = cuda_dtw.dtw_path_cuda.launches
        value = float(step(*(t.to(dev) for t in args)))
        launches = cuda_dtw.dtw_path_cuda.launches - before
        out[str(dev)] = (value, opt.num_linesearch_steps, launches,
                         to_jax_numpy(net)[0])
    card, cpu = out[str(cuda_device)], out["cpu"]
    assert abs(card[0] - cpu[0]) <= 1e-4 * abs(cpu[0])
    assert card[1] == cpu[1] >= 1
    assert (card[2], cpu[2]) == (1, 0)
    for layer in cpu[3]:
        for k in cpu[3][layer]:
            diff = abs(card[3][layer][k] - cpu[3][layer][k]).max()
            assert diff <= 1e-5, (layer, k, diff)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["bfloat16", "int8", "int4"])
def test_codec_on_the_card_equals_the_cpu(cuda_device, codec):
    """The card's encode of a float32 chunk, decoded on the host, equals
    the CPU's encode of the same chunk, decoded the same way; every leaf
    is equal too (odd d: int4's pad column)."""
    from abnet3_torch.embedder import decode_transfer, encode_transfer
    g = torch.Generator().manual_seed(20)
    x = torch.rand(5000, 101, generator=g)
    card = encode_transfer(x.to(cuda_device), codec)
    cpu = encode_transfer(x, codec)
    for a, b in zip(card, cpu):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a.cpu(), b)
    assert (decode_transfer(card) == decode_transfer(cpu)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["float32", "int8"])
def test_streaming_on_the_card_equals_the_corpus_path(cuda_device, codec):
    """An in-memory stream with empty files first and in the middle:
    every file's embeddings equal the corpus path's on the card (the
    same chunks, so the same GEMMs and, for int8, the same scales)."""
    from abnet3_torch.embedder import EmbedderSiamese
    from abnet3_torch.models.siamese import SiameseNetwork
    rng = torch.Generator().manual_seed(21)
    lens = [0, 700, 333, 0, 1200, 41]
    feats = [torch.randn(n, 40, generator=rng).numpy() for n in lens]
    net = SiameseNetwork(input_dim=40, num_hidden_layers=1, hidden_dim=64,
                         output_dim=16, p_dropout=0.0,
                         activation_layer="sigmoid", device=cuda_device)
    emb = EmbedderSiamese(network=net, batch_size=512, transfer_dtype=codec)
    emb._load()
    full = emb._embed_corpus(emb._forward_fn(), feats)
    got = []
    emb._embed_streaming(
        emb._forward_fn(),
        ((f"f{i}", None, f) for i, f in enumerate(feats)),
        lambda item, labels, embs: got.append((item, embs[0])))
    assert [item for item, _ in got] == [f"f{i}" for i in range(len(lens))]
    for (_, a), b in zip(got, full):
        assert a.shape == b.shape and (a == b).all()


@pytest.mark.cuda
def test_loader_pickle_on_the_card_holds_no_tensor(cuda_device, tmp_path):
    """A bank loader on the card pickles without a tensor and rebuilds
    its bank on the card; the first seeded batch is the original's."""
    import pickle
    import random
    import numpy as np
    from abnet3_torch.dataloader import OriginalDataLoader
    from abnet3_torch.utils import Features_Accessor
    rng = np.random.RandomState(22)
    feats = {f"f{i}": rng.randn(80, 4).astype(np.float32) for i in range(3)}
    times = {f: np.arange(80) * 0.01 + 0.0025 for f in feats}
    pairs = {"train": [("f0", 0.0, 0.2, "f1", 0.1, 0.3, "same"),
                       ("f1", 0.3, 0.5, "f2", 0.0, 0.1, "diff"),
                       ("f2", 0.2, 0.4, "f0", 0.4, 0.6, "same")],
             "dev": [("f0", 0.5, 0.7, "f2", 0.5, 0.6, "diff")]}
    loader = OriginalDataLoader(None, None, batch_size=2, seed=0,
                                align_backend="bank", tcl=0.2)
    loader.features = Features_Accessor(times, feats)
    loader.pairs = pairs
    loader.load_data()
    assert loader.token_bank.bank.device.type == "cuda"
    from chip_smoke import reachable
    blob = pickle.dumps(loader)
    state = loader.__getstate__()
    assert state["token_bank"] is None and state["frame_bank"] is None
    assert not any(isinstance(v, torch.Tensor) for v in reachable(state))
    restored = pickle.loads(blob)
    assert restored.token_bank.bank.device.type == "cuda"
    assert torch.equal(restored.token_bank.bank, loader.token_bank.bank)
    batches = []
    for dl in (loader, restored):
        random.seed(0)
        np.random.seed(0)
        dl._rng = np.random.RandomState(0)
        batches.append(next(iter(dl.batch_iterator(train_mode=True))))
    for a, b in zip(*batches):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.cuda
def test_pipeline_learns_on_the_card(cuda_device, tmp_path):
    """tests/test_torch_quality.py's siamese case on the card (ROADMAP
    A14): the train loss falls and the trained ABX proxy is under 0.7x
    the raw features'."""
    from chip_smoke import learning_check
    out = learning_check(str(tmp_path))
    losses = out["train_losses"]
    assert losses[-1] < losses[0]
    assert out["trained"] < out["raw"] * 0.7



def _multimodal(device, frozen=False, seed=0):
    """A multimodal network (two pre-nets, an attention unit, a post-net,
    batch norm) on ``device``, its weights drawn from ``seed`` on the
    CPU; the unit frozen to 0.5 when ``frozen``."""
    from abnet3_torch.integration import BiWeightedDeepLearnt
    from abnet3_torch.models.multimodal import MultimodalSiameseNetwork
    unit = BiWeightedDeepLearnt(net_params=[[16, 1], [16, 1]],
                                integration_mode="sum")
    if frozen:
        unit.set_headstart_weight(0.5)
    net = MultimodalSiameseNetwork(
        integration_unit=unit, pre_integration_net_params=[[12, 16],
                                                           [9, 16]],
        post_integration_net_params=[16, 8], p_dropout=0.0,
        batch_norm=True, activation_layer="sigmoid", device=device)
    net.ensure_init(seed)
    return net


def _leaves(tree):
    """The arrays of nested dicts (by sorted key) and tuples."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.cuda
@pytest.mark.parametrize("frozen", [False, True])
def test_multimodal_frame_step_on_the_card_matches_the_cpu(cuda_device,
                                                          frozen):
    """make_frame_train_step(multimodal=True): one adadelta step on the
    card equals the CPU's on the same two tables and index batch (padded
    rows of weight 0): loss rtol 1e-4, parameters and batch-norm state
    atol 1e-5, with the unit learning and frozen to its headstart."""
    import numpy as np

    from abnet3_torch.loss import coscos2
    from abnet3_torch.parallel import make_frame_train_step
    from abnet3_torch.trainer import build_optimizer
    from abnet3_torch.weights import to_jax_numpy
    g = torch.Generator().manual_seed(17)
    tables = (torch.randn(300, 12, generator=g),
              torch.randn(300, 9, generator=g))
    i1 = torch.randint(0, 300, (64,), generator=g)
    i2 = torch.randint(0, 300, (64,), generator=g)
    y = torch.where(torch.rand(64, generator=g) < 0.5, 1.0, -1.0)
    w = torch.ones(64)
    w[-9:] = 0.0
    out = {}
    for name, dev in (("card", cuda_device), ("cpu", torch.device("cpu"))):
        net = _multimodal(dev, frozen)
        opt = build_optimizer("adadelta", net.parameters(), 0.1)
        step, _ = make_frame_train_step(
            net, coscos2(), opt, tuple(t.to(dev) for t in tables),
            multimodal=True)
        loss = float(step(*(t.to(dev) for t in (i1, i2, y, w))))
        out[name] = (loss, _leaves(to_jax_numpy(net)))
    assert abs(out["card"][0] - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0])
    for a, b in zip(out["card"][1], out["cpu"][1]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_multimodal_frozen_main_on_the_card(cuda_device, tmp_path):
    """MultimodalTrainer on the card with a headstart of one pass (the
    epoch-0 eval): from the first epoch on, every pre-net and post-net
    parameter stays bit for bit as initialised, the attention towers
    move, and the losses are finite."""
    import numpy as np

    from abnet3_torch.dataloader import MultimodalDataLoader
    from abnet3_torch.loss import coscos2
    from abnet3_torch.trainer import MultimodalTrainer
    from abnet3_torch.utils import Features_Accessor
    from abnet3_torch.weights import to_jax_numpy
    g = torch.Generator().manual_seed(18)
    times = {f"f{i}": np.arange(200) * 0.01 + 0.0025 for i in range(4)}
    dl = MultimodalDataLoader(None, ["a", "b"], batch_size=64,
                              device=cuda_device)
    dl.features_dict = {m: Features_Accessor(times, {
        k: torch.randn(200, d, generator=g).numpy() for k in times})
        for m, d in (("a", 12), ("b", 9))}
    rng = np.random.RandomState(19)
    pairs = []
    for k in range(60):
        f1, f2 = rng.randint(4, size=2)
        s1, s2 = rng.randint(0, 150, size=2) * 0.01
        n1, n2 = rng.randint(5, 40, size=2) * 0.01
        pairs.append((f"f{f1}", s1, s1 + n1, f"f{f2}", s2, s2 + n2,
                      "same" if k % 3 else "diff"))
    dl.pairs = {"train": pairs[:45], "dev": pairs[45:]}
    dl._rng = np.random.RandomState(0)
    net = _multimodal(cuda_device)
    net.output_path = str(tmp_path / "net")
    before = to_jax_numpy(net)[0]
    tr = MultimodalTrainer(network=net, loss=coscos2(), dataloader=dl,
                           optimizer_type="adam", lr=0.01, num_epochs=2,
                           seed=0, log_dir=str(tmp_path),
                           headstart=(1, False, 0.5), device=cuda_device)
    tr.train()
    after = to_jax_numpy(net)[0]
    assert tr._frozen_main and np.isfinite(tr.train_losses).all()
    for k in ("pre_0", "pre_1", "post"):
        for a, b in zip(_leaves(before[k]), _leaves(after[k])):
            assert np.array_equal(a, b)
    assert all(not np.array_equal(a, b) for a, b in zip(
        _leaves(before["integration"]), _leaves(after["integration"])))


@pytest.mark.cuda
def test_multimodal_export_on_the_card_matches_the_cpu(cuda_device):
    """MultimodalEmbedder.embed_modalities on the card and on the CPU,
    the same weights and per-modality lists (a chunk cuts across files):
    the embeddings and the attention weights within rtol 1e-4 (atol
    1e-6), the weights in (0, 1) with shape (frames, 1) a file."""
    import numpy as np

    from abnet3_torch.embedder import MultimodalEmbedder
    g = torch.Generator().manual_seed(20)
    lengths = [300, 45, 700, 1]
    mods = [[torch.randn(n, d, generator=g).numpy() for n in lengths]
            for d in (12, 9)]
    out = {}
    for name, dev in (("card", cuda_device), ("cpu", torch.device("cpu"))):
        emb = MultimodalEmbedder(network=_multimodal(dev), output_path="x",
                                 batch_size=256, device=dev)
        out[name] = emb.embed_modalities(mods)
    for a, b in zip(out["card"][0] + out["card"][1],
                    out["cpu"][0] + out["cpu"][1]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    for w, n in zip(out["card"][1], lengths):
        assert w.shape == (n, 1) and ((w > 0) & (w < 1)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5000, 280, 500), (64, 500, 100)])
def test_bf16_matmul_on_the_card_matches_plain(cuda_device, shape):
    """The tower's bf16 product on the tensor cores (bf16 inputs, float32
    output) against its plain version on the same card: the forward
    within rtol 1e-5 (atol 1e-5; summation order only), the gradients
    (float32 products rounded to bf16, computed alike) within 1 bf16
    ulp."""
    from abnet3_torch.nn import bf16_matmul, bf16_matmul_plain
    n, k, m = shape
    g = torch.Generator().manual_seed(21)
    x = torch.randn(n, k, generator=g).to(cuda_device)
    w = (0.05 * torch.randn(k, m, generator=g)).to(cuda_device)
    up = torch.randn(n, m, generator=g).to(cuda_device)
    outs = []
    for fn in (bf16_matmul, bf16_matmul_plain):
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = fn(xg, wg)
        (y * up).sum().backward()
        outs.append((y.detach(), xg.grad, wg.grad))
    assert outs[0][0].dtype == torch.float32
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-5, atol=1e-5)
    for a, b in zip(outs[0][1:], outs[1][1:]):
        ulps = (a.bfloat16().view(torch.int16).int()
                - b.bfloat16().view(torch.int16).int()).abs()
        assert int(ulps.max()) <= 1


@pytest.mark.cuda
def test_world_size_one_nccl_step_equals_mesh_free(cuda_device):
    """A (1, 1) mesh on NCCL (a one-rank group that make_mesh starts):
    three split steps equal the mesh-free steps bit for bit."""
    import numpy as np
    import torch.distributed as dist

    from abnet3_torch.loss import coscos2
    from abnet3_torch.models.siamese import SiameseNetwork
    from abnet3_torch.ops.bank import TokenBank
    from abnet3_torch.parallel import make_mesh, make_split_pair_train_step
    from abnet3_torch.trainer import build_optimizer
    rng = np.random.RandomState(0)
    feats = {i: rng.randn(rng.randint(4, 30), 10).astype(np.float32)
             for i in range(40)}
    ids = torch.arange(22, device=cuda_device)
    ws = torch.ones(6, device=cuda_device)
    wd = torch.ones(5, device=cuda_device)
    batch = (ids[:6], ids[6:12], ws, ids[12:17], ids[17:22], wd)

    def run(mesh):
        net = SiameseNetwork(input_dim=10, num_hidden_layers=1,
                             hidden_dim=16, output_dim=8, p_dropout=0.2,
                             batch_norm=True, activation_layer="sigmoid",
                             device=cuda_device)
        net.ensure_init(3)
        opt = build_optimizer("adadelta", net.parameters(), 0.1)
        step, _ = make_split_pair_train_step(
            net, coscos2(), opt, TokenBank(feats, device=cuda_device),
            mesh=mesh)
        losses = torch.stack([step(*batch) for _ in range(3)])
        return losses, [p.detach().clone() for p in net.parameters()]

    plain = run(None)
    try:
        mesh = make_mesh(1, 1, device=cuda_device)
        assert dist.get_backend() == "nccl"
        meshed = run(mesh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert torch.equal(plain[0], meshed[0])
    assert all(torch.equal(a, b) for a, b in zip(plain[1], meshed[1]))
