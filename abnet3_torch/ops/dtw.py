"""Batched DTW alignment on the device.

The counterpart of ``abnet3_tpu/ops/dtw.py`` for the matrix-mode train
step:

1. :func:`pairwise_angular_distance` computes all B cost matrices with one
   batched matmul (angular cosine distance, reference utils.py:40-60);
   :func:`pairwise_kl_distance` is the posteriorgram metric. Their anchor
   forms (:func:`anchor_angular_distance_rows`,
   :func:`anchor_kl_distance_rows`) score ONE token against a block in the
   (T1, B, T2) rows layout of the ABX tiles.
2. :func:`dtw_costs`, :func:`moves_from_costs` and
   :func:`onpath_from_moves` are the plain twins of the DTW path-mask
   kernel: the DP cost tensor, its argmin moves (3=diag, 2=up, 1=left;
   ties go diag, then up), and the mask of the cells the backtrace from
   (n1-1, n2-1) visits.
3. :func:`dtw_path_from_dist` (path mask), :func:`dtw_path_stats` and
   :func:`dtw_path_stats_rows` (path sum and length) and
   :func:`dtw_moves_auto` (the move matrix) dispatch: a CUDA tensor goes
   to the hand-written kernels (:mod:`abnet3_torch.ops.cuda_dtw`), a CPU
   tensor to their plain twins.
4. The gather path: :func:`walk_moves` walks each pair's moves back from
   its endpoint into index paths (a CUDA tensor runs the hand-written
   walk kernel, one launch for the batch; a CPU tensor the plain loop,
   :func:`walk_moves_plain`), :func:`dtw_align_from_dist` and
   :func:`dtw_align_batch` chain distances, moves and walk, and
   :func:`gather_aligned` picks the aligned frames.

:func:`dtw_costs` runs the recurrence ``D[i,j] = d[i,j] + min(up, left,
diag)`` one anti-diagonal at a time, so each cell is one float32 add of
``d`` and an exact minimum: the CUDA kernel does the same arithmetic and
its masks equal the plain version's bit for bit. The JAX package's row
scan computes the same D through a (min,+) closed form whose cumulative
sums round differently (agreement within float32 rounding; the moves and
masks agree exactly on the tested inputs, ties included).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from abnet3_torch.profiling import span

__all__ = ["pairwise_angular_distance", "unit_frames",
           "anchor_angular_distance_rows", "dtw_path_stats_auto",
           "pairwise_kl_distance", "anchor_kl_distance_rows", "dtw_costs",
           "moves_from_costs", "onpath_from_moves", "dtw_path_from_dist",
           "dtw_path_stats", "dtw_path_stats_rows", "dtw_moves_auto",
           "walk_moves", "walk_moves_plain", "dtw_backtrace",
           "dtw_align_from_dist", "dtw_align_batch", "gather_aligned",
           "align_diff_batch", "aligned_frame_pairs"]

# the "no neighbour" cost of the boundary cells, as in the JAX package
_BIG = 1e30


def pairwise_angular_distance(x: torch.Tensor, y: torch.Tensor
                              ) -> torch.Tensor:
    """Batched angular cosine distance arccos(cos)/pi in [0, 1].

    x: (B, T1, d), y: (B, T2, d) -> (B, T1, T2). Zero-norm frames are
    distance 1 from everything except other zero-norm frames (distance 0),
    matching reference utils.py:40-60.
    """
    x = x.float()
    y = y.float()
    nx = torch.sqrt(torch.sum(x * x, dim=-1))          # (B, T1)
    ny = torch.sqrt(torch.sum(y * y, dim=-1))          # (B, T2)
    zx = nx == 0.0
    zy = ny == 0.0
    dots = torch.bmm(x, y.transpose(1, 2))
    denom = (torch.where(zx, 1.0, nx)[:, :, None]
             * torch.where(zy, 1.0, ny)[:, None, :])
    sim = torch.clamp(dots / denom, -1.0, 1.0)
    d = torch.arccos(sim) / math.pi
    d = torch.where(zx[:, :, None] | zy[:, None, :], 1.0, d)
    d = torch.where(zx[:, :, None] & zy[:, None, :], 0.0, d)
    return d


def unit_frames(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frames scaled to unit norm, in float64, and the mask of zero-norm
    frames (which stay zero): (..., d) -> ((..., d) float64, (...) bool)."""
    y = y.double()
    n = torch.sqrt(torch.sum(y * y, dim=-1))
    zero = n == 0.0
    return y / torch.where(zero, 1.0, n)[..., None], zero


def anchor_angular_distance_rows(
        xa: torch.Tensor, y: torch.Tensor,
        y_unit: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
) -> torch.Tensor:
    """Angular distance of ONE anchor against a token block in the rows
    layout: xa (T1, d), y (B, T2, d) -> (T1, B, T2) float32.

    The cells of ``pairwise_angular_distance(broadcast(xa), y)``
    transposed, from one matmul whose output is already the layout the
    stats kernel reads (no anchor broadcast, no transpose). The cosines
    come from unit frames in float64, rounded once to float32 before the
    arccos: near-parallel frames (cosines within 1e-4 of 1, as a
    briefly trained tower emits) put arccos's slope at 40 and more, and
    float32 dot products summed in another order (cuBLAS vs the CPU)
    then differ by several u16 codec steps; float64 makes the card and
    the CPU agree. ``y_unit``, :func:`unit_frames` of ``y``, may be
    passed by a caller that scores many anchors against one block. The
    float32 tail runs in place on one (T1, B, T2) buffer."""
    xu, zx = unit_frames(xa)                            # (T1, d), (T1,)
    yu, zy = unit_frames(y) if y_unit is None else y_unit
    T1, (B, T2, dim) = xu.shape[0], yu.shape
    d = torch.mm(xu, yu.reshape(B * T2, dim).t()).view(T1, B, T2).float()
    d.clamp_(-1.0, 1.0).arccos_().div_(math.pi)
    d.masked_fill_(zx[:, None, None] | zy[None], 1.0)
    d.masked_fill_(zx[:, None, None] & zy[None], 0.0)
    return d


def _distributions(x: torch.Tensor, eps: float):
    """Frames clipped at ``eps`` and renormalised, and their logs."""
    p = torch.clamp(x.float(), min=eps)
    p = p / torch.sum(p, dim=-1, keepdim=True)
    return p, torch.log(p)


def pairwise_kl_distance(x: torch.Tensor, y: torch.Tensor,
                         eps: float = 1e-10) -> torch.Tensor:
    """Batched symmetrised KL divergence between posteriorgram frames:
    x (B, T1, d), y (B, T2, d) -> (B, T1, T2) with
    d[i, j] = 0.5 * (KL(p_i || q_j) + KL(q_j || p_i)), ABXpy's ``dtw_kl``
    frame metric. Rows are clipped at ``eps`` and renormalised first, so
    zero padding rows become uniform and the logs are finite."""
    p, logp = _distributions(x, eps)
    q, logq = _distributions(y, eps)
    self_p = torch.sum(p * logp, dim=-1)                # (B, T1)
    self_q = torch.sum(q * logq, dim=-1)                # (B, T2)
    cross_pq = torch.einsum("bik,bjk->bij", p, logq)
    cross_qp = torch.einsum("bik,bjk->bij", logp, q)
    return 0.5 * ((self_p[:, :, None] - cross_pq)
                  + (self_q[:, None, :] - cross_qp))


def anchor_kl_distance_rows(xa: torch.Tensor, y: torch.Tensor,
                            eps: float = 1e-10) -> torch.Tensor:
    """The anchor form of :func:`pairwise_kl_distance`: xa (T1, d),
    y (B, T2, d) -> (T1, B, T2), the rows layout of the stats kernel."""
    p, logp = _distributions(xa, eps)
    q, logq = _distributions(y, eps)
    self_p = torch.sum(p * logp, dim=-1)                # (T1,)
    self_q = torch.sum(q * logq, dim=-1)                # (B, T2)
    cross_pq = torch.einsum("ik,bjk->ibj", p, logq)
    cross_qp = torch.einsum("ik,bjk->ibj", logp, q)
    return 0.5 * ((self_p[:, None, None] - cross_pq)
                  + (self_q[None] - cross_qp))


def dtw_costs(dist: torch.Tensor) -> torch.Tensor:
    """Full DP cost tensor: dist (B, T1, T2) -> D (B, T1, T2) with
    D[i,j] = dist[i,j] + min(D[i-1,j], D[i,j-1], D[i-1,j-1]), missing
    neighbours counting as BIG and D[0,0] = dist[0,0]."""
    B, T1, T2 = dist.shape
    dev = dist.device
    D = torch.empty_like(dist)
    big = torch.tensor(_BIG, dtype=dist.dtype, device=dev)
    for k in range(T1 + T2 - 1):
        j = torch.arange(max(0, k - T1 + 1), min(k, T2 - 1) + 1, device=dev)
        i = k - j
        c = dist[:, i, j]
        if k == 0:
            D[:, i, j] = c + 0.0
            continue
        im, jm = (i - 1).clamp(min=0), (j - 1).clamp(min=0)
        up = torch.where(i >= 1, D[:, im, j], big)
        left = torch.where(j >= 1, D[:, i, jm], big)
        diag = torch.where((i >= 1) & (j >= 1), D[:, im, jm], big)
        D[:, i, j] = c + torch.minimum(torch.minimum(diag, up), left)
    return D


def moves_from_costs(D: torch.Tensor) -> torch.Tensor:
    """Argmin move matrix of a DP cost tensor: 3=diag, 2=up, 1=left
    (boundary cells compare against BIG; ties go diag, then up)."""
    B, T1, T2 = D.shape
    pad = torch.nn.functional.pad
    diag = pad(D[:, :-1, :-1], (1, 0, 1, 0), value=_BIG)
    up = pad(D[:, :-1, :], (0, 0, 1, 0), value=_BIG)
    left = pad(D[:, :, :-1], (1, 0), value=_BIG)
    take_diag = (diag <= up) & (diag <= left)
    take_up = (~take_diag) & (up <= left)
    di = (take_diag | take_up).to(torch.int8)
    dj = (take_diag | ~take_up).to(torch.int8)
    return di * 2 + dj


def onpath_from_moves(move: torch.Tensor, n1: torch.Tensor,
                      n2: torch.Tensor) -> torch.Tensor:
    """Alignment-path mask from a move matrix.

    move: (B, T1, T2) argmin moves as produced by
    :func:`moves_from_costs`; n1, n2: (B,) true lengths. Returns A
    (B, T1, T2) float32 with A[i, j] = 1 exactly on the cells of the
    backtrace chain from (n1-1, n2-1) to (0, 0), computed as the JAX
    package does, by a reverse row DP:

        R[i, j] = seed | (R[i+1, j] & mv[i+1, j]==up)
                       | (R[i+1, j+1] & mv[i+1, j+1]==diag)
                       | (R[i, j+1] & mv[i, j+1]==left)

    whose within-row OR-scan over left moves has the closed form
    R[j] = (min_{k>=j, ext[k]} cnt[k]) == cnt[j], with cnt[j] the number
    of non-left moves at t <= j (a cumsum and a suffix min per row).
    """
    B, T1, T2 = move.shape
    dev = move.device
    mv = move.to(torch.int32)
    jj = torch.arange(T2, device=dev)[None, :]
    seed_col = jj == (n2.to(dev) - 1)[:, None]               # (B, T2)
    is_end = (n1.to(dev) - 1)[:, None]                       # (B, 1)
    not_left_cnt = torch.cumsum((mv != 1).float(), dim=2)
    out = torch.empty((B, T1, T2), dtype=torch.float32, device=dev)
    r_below = torch.zeros((B, T2), dtype=torch.bool, device=dev)
    mv_below = torch.zeros((B, T2), dtype=torch.int32, device=dev)
    no_col = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    for i in range(T1 - 1, -1, -1):
        cnt = not_left_cnt[:, i]
        from_up = r_below & (mv_below == 2)
        from_diag = torch.cat([(r_below & (mv_below == 3))[:, 1:], no_col],
                              dim=1)
        ext = ((is_end == i) & seed_col) | from_up | from_diag
        m = torch.where(ext, cnt, _BIG)
        sufmin = torch.flip(torch.cummin(torch.flip(m, (1,)), dim=1).values,
                            (1,))
        r = sufmin == cnt
        out[:, i] = r.float()
        r_below, mv_below = r, mv[:, i]
    return out


def _on_data_axis(mesh, fn, dist, n1, n2):
    """``fn(dist, n1, n2)`` of a global batch of pairs. On a ``mesh`` with
    a 'data' axis of several ranks each rank runs ``fn`` (its kernel) on
    its block of the pairs (padded to a multiple of the axis with
    zero-distance pairs of length 1), and the blocks are gathered over
    'data': every rank returns the global result, as the JAX package's
    ``shard_map`` does. Without a mesh, or on an axis of 1, ``fn`` of the
    whole batch, with no collective."""
    if mesh is None:
        return fn(dist, n1, n2)
    from abnet3_torch.dist import Shard, all_gather_rows
    shard = Shard(mesh)
    if shard.n_data == 1:
        return fn(dist, n1, n2)
    n = dist.shape[0]
    out = fn(*shard.take("p", [dist, n1, n2], [0.0, 1, 1]))

    def gather(t):
        return all_gather_rows(t, shard.data_group, shard.n_data)[:n]
    return tuple(map(gather, out)) if isinstance(out, tuple) else gather(out)


def dtw_path_from_dist(dist: torch.Tensor, n1: torch.Tensor,
                       n2: torch.Tensor, mesh=None) -> torch.Tensor:
    """Alignment-path mask A (B, T1, T2) float32 from a distance tensor:
    A[b, i, j] = 1 exactly on the backtrace-path cells, A.sum((1, 2)) is
    the path length. A CUDA tensor runs the hand-written kernel, a CPU
    tensor the plain version. With a ``mesh`` each rank launches the
    kernel on its block of the pairs and the masks are gathered
    (``dtw_path_pallas_sharded``, see :func:`_on_data_axis`)."""
    if mesh is not None:
        return _on_data_axis(mesh, dtw_path_from_dist, dist, n1, n2)
    from abnet3_torch.ops import cuda_dtw
    if dist.is_cuda:
        return cuda_dtw.dtw_path_cuda(dist.float().contiguous(),
                                      n1.to(torch.int32).contiguous(),
                                      n2.to(torch.int32).contiguous())
    return cuda_dtw.dtw_path_plain(dist, n1, n2)


def _last_dim_contiguous(dist: torch.Tensor) -> torch.Tensor:
    """float32 with unit stride along the last dimension (what the stats
    kernel reads through its strides), copying only when needed."""
    dist = dist.float()
    return dist if dist.stride(-1) == 1 else dist.contiguous()


def dtw_path_stats(dist: torch.Tensor, n1: torch.Tensor,
                   n2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(path_sum, path_len) of the DTW backtrace path of each pair: dist
    (B, T1, T2), n1/n2 (B,) true lengths -> two (B,) float32. path_sum is
    the DP cost at (n1-1, n2-1), the sum of ``dist`` along the path;
    path_len its exact integer length. A CUDA tensor runs the
    hand-written kernel, a CPU tensor the plain version."""
    from abnet3_torch.ops import cuda_dtw
    if dist.is_cuda:
        return cuda_dtw.dtw_path_stats_cuda(
            _last_dim_contiguous(dist), n1.to(torch.int32).contiguous(),
            n2.to(torch.int32).contiguous())
    return cuda_dtw.dtw_path_stats_plain(dist, n1, n2)


def dtw_path_stats_auto(dist: torch.Tensor, n1: torch.Tensor,
                        n2: torch.Tensor, mesh=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`dtw_path_stats`; with a ``mesh`` each rank runs its block
    of the pairs and the statistics are gathered (the JAX package's
    ``shard_map`` over 'data', see :func:`_on_data_axis`)."""
    return _on_data_axis(mesh, dtw_path_stats, dist, n1, n2)


def dtw_path_stats_rows(dist_rows: torch.Tensor, n1: torch.Tensor,
                        n2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`dtw_path_stats` of a (T1, B, T2) rows-layout tensor (the
    ABX tile row: one anchor against B column tokens). The kernel reads
    it in place; the plain version through a transposed view."""
    from abnet3_torch.ops import cuda_dtw
    if dist_rows.is_cuda:
        return cuda_dtw.dtw_path_stats_cuda(
            _last_dim_contiguous(dist_rows), n1.to(torch.int32).contiguous(),
            n2.to(torch.int32).contiguous(), rows=True)
    return cuda_dtw.dtw_path_stats_plain(dist_rows.permute(1, 0, 2), n1, n2)


def dtw_moves_auto(dist: torch.Tensor) -> torch.Tensor:
    """Move matrix (B, T1, T2) int8 of a distance tensor: a CUDA tensor
    runs the hand-written kernel, a CPU tensor the plain version."""
    from abnet3_torch.ops import cuda_dtw
    if dist.is_cuda:
        return cuda_dtw.dtw_moves_cuda(dist.float().contiguous())
    return cuda_dtw.dtw_moves_plain(dist)


def walk_moves(move: torch.Tensor, n1: torch.Tensor, n2: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Walk move matrices back from each pair's endpoint (n1-1, n2-1).

    move (B, T1, T2) as produced by :func:`moves_from_costs`; n1, n2 (B,)
    true lengths. Returns (path1, path2, path_len): paths (B, L) int64
    with L = T1+T2-1 in increasing order, padded past path_len by
    repeating the endpoint, as the JAX package's ``walk_moves``. A CUDA
    tensor runs the hand-written walk kernel (one launch, int8 moves read
    in place), a CPU tensor the plain loop, :func:`walk_moves_plain`; the
    two give the same integers."""
    from abnet3_torch.ops import cuda_dtw
    if move.is_cuda:
        dev = move.device
        return cuda_dtw.walk_moves_cuda(
            move.to(torch.int8).contiguous(),
            n1.to(dev, torch.int32).contiguous(),
            n2.to(dev, torch.int32).contiguous())
    return walk_moves_plain(move, n1, n2)


def walk_moves_plain(move: torch.Tensor, n1: torch.Tensor, n2: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The walk kernel's function in plain PyTorch, on any device: one
    step per loop iteration for all B pairs at once, L = T1+T2-1 of them;
    a coordinate that a move would take below 0 stays at 0, so the walk
    rests at (0, 0). A move code m steps back (m >> 1, m & 1): 1 = left
    (0, 1), 2 = up (1, 0), 3 = diag (1, 1). Nothing is read back to the
    host."""
    B, T1, T2 = move.shape
    L = T1 + T2 - 1
    dev = move.device
    flat = move.reshape(B, T1 * T2).long()
    ij = torch.stack([n1.to(dev).long() - 1, n2.to(dev).long() - 1])
    trail = torch.empty((L, 2, B), dtype=torch.long, device=dev)
    for s in range(L):
        trail[s] = ij
        m = flat.gather(1, (ij[0] * T2 + ij[1])[:, None])[:, 0]
        ij = (ij - torch.stack([m >> 1, m & 1])).clamp_(min=0)
    ris, rjs = trail[:, 0].t(), trail[:, 1].t()             # (B, L)
    # the walk goes from the endpoint back to (0, 0), then repeats it
    at_origin = (ris == 0) & (rjs == 0)
    plen = L - at_origin.sum(1) + 1
    idx = (plen[:, None] - 1
           - torch.arange(L, device=dev)[None, :]).clamp(0, L - 1)
    return ris.gather(1, idx), rjs.gather(1, idx), plen


def dtw_backtrace(D: torch.Tensor, n1: torch.Tensor, n2: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Optimal paths from a DP cost tensor D (B, T1, T2), walked back from
    each pair's true endpoint; output as :func:`walk_moves`."""
    return walk_moves(moves_from_costs(D), n1, n2)


def dtw_align_from_dist(dist: torch.Tensor, n1: torch.Tensor,
                        n2: torch.Tensor, mesh=None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Alignment paths from a distance tensor: the move kernel (on a CUDA
    tensor) or its plain version, then :func:`walk_moves`. With a
    ``mesh`` each rank aligns its block of the pairs and the paths are
    gathered (``dtw_moves_pallas_sharded``, see :func:`_on_data_axis`)."""
    if mesh is not None:
        return _on_data_axis(mesh, dtw_align_from_dist, dist, n1, n2)
    return walk_moves(dtw_moves_auto(dist), n1, n2)


def dtw_align_batch(f1: torch.Tensor, f2: torch.Tensor, n1: torch.Tensor,
                    n2: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """DTW alignment of padded token pairs: f1 (B, T1, d), f2 (B, T2, d)
    zero-padded, n1/n2 (B,) true lengths -> (path1, path2, path_len) as
    in :func:`walk_moves`."""
    return dtw_align_from_dist(pairwise_angular_distance(f1, f2), n1, n2)


def gather_aligned(f: torch.Tensor, path: torch.Tensor) -> torch.Tensor:
    """Aligned frames: f (B, T, d), path (B, L) -> (B, L, d)."""
    index = path.long()[:, :, None].expand(-1, -1, f.shape[-1])
    return torch.gather(f, 1, index)


def align_diff_batch(n1: torch.Tensor, n2: torch.Tensor, T1: int, T2: int,
                     align_different_words: bool = False,
                     L: Optional[int] = None):
    """Alignment index paths for *different*-word pairs.

    - truncate mode (default): both words cut to min(n1, n2)
      (reference dataloader.py:227-228)
    - diagonal mode: the shorter word is stretched along the diagonal with
      rounded linspace indices (reference dataloader.py:217-225)

    Returns (path1, path2, path_len) with L = max(T1, T2) by default;
    entries past path_len repeat clamped indices and are masked by
    callers.
    """
    if L is None:
        L = max(T1, T2)
    assert L >= max(T1, T2)
    s = torch.arange(L, dtype=torch.float32, device=n1.device)[None, :]
    n1f = n1.float()[:, None]
    n2f = n2.float()[:, None]
    if align_different_words:
        plen = torch.maximum(n1, n2)
        denom = torch.clamp(plen.float()[:, None] - 1.0, min=1.0)
        p1 = torch.round(s * (n1f - 1.0) / denom).long()
        p2 = torch.round(s * (n2f - 1.0) / denom).long()
    else:
        plen = torch.minimum(n1, n2)
        p1 = torch.minimum(s, n1f - 1.0).long()
        p2 = torch.minimum(s, n2f - 1.0).long()
    return p1.clamp(0, T1 - 1), p2.clamp(0, T2 - 1), plen


def aligned_frame_pairs(f1: torch.Tensor, f2: torch.Tensor,
                        n1: torch.Tensor, n2: torch.Tensor, same: bool,
                        align_different_words: bool = False,
                        pair_w: Optional[torch.Tensor] = None,
                        spans: Optional[Tuple[str, str, str]] = None):
    """Aligned frame pairs of one group of padded token pairs: f1 (B, T1,
    d), f2 (B, T2, d), n1/n2 (B,) true lengths.

    Same-word pairs are aligned by DTW (:func:`dtw_align_batch`, L =
    T1+T2-1), different-word pairs by :func:`align_diff_batch` (L =
    max(T1, T2)). Returns (x1, x2, y, w): the gathered frames flattened to
    (B*L, d) each, y (B*L,) +1 or -1, and w (B*L,) 1 on each path's steps
    and 0 past them, times the per-pair weight ``pair_w`` (B,) if given.
    ``spans``: the names of the spans (:mod:`abnet3_torch.profiling`)
    around the alignment (distances and moves, or the different words'
    paths), :func:`walk_moves` and the gathers.
    """
    align, walk, gather = spans or (None, None, None)
    if same:
        with span(align):
            move = dtw_moves_auto(pairwise_angular_distance(f1, f2))
        with span(walk):
            p1, p2, plen = walk_moves(move, n1, n2)
    else:
        with span(align):
            p1, p2, plen = align_diff_batch(
                n1, n2, f1.shape[1], f2.shape[1],
                align_different_words=align_different_words)
    with span(gather):
        x1 = gather_aligned(f1, p1)                      # (B, L, d)
        x2 = gather_aligned(f2, p2)
        B, L, d = x1.shape
        dev = x1.device
        w = (torch.arange(L, device=dev)[None, :] < plen[:, None]).float()
        if pair_w is not None:
            w = w * pair_w[:, None]
        y = torch.full((B * L,), 1.0 if same else -1.0, device=dev)
        return x1.reshape(-1, d), x2.reshape(-1, d), y, w.reshape(-1)
