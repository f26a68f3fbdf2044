"""Batched DTW alignment on the device.

The counterpart of ``abnet3_tpu/ops/dtw.py`` for the matrix-mode train
step:

1. :func:`pairwise_angular_distance` computes all B cost matrices with one
   batched matmul (angular cosine distance, reference utils.py:40-60).
2. :func:`dtw_costs`, :func:`moves_from_costs` and
   :func:`onpath_from_moves` are the plain twins of the DTW path-mask
   kernel: the DP cost tensor, its argmin moves (3=diag, 2=up, 1=left;
   ties go diag, then up), and the mask of the cells the backtrace from
   (n1-1, n2-1) visits.
3. :func:`dtw_path_from_dist` dispatches: a CUDA tensor goes to the
   hand-written kernel (:mod:`abnet3_torch.ops.cuda_dtw`), a CPU tensor to
   the plain twins.

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
from typing import Optional

import torch

__all__ = ["pairwise_angular_distance", "dtw_costs", "moves_from_costs",
           "onpath_from_moves", "dtw_path_from_dist", "align_diff_batch"]

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


def dtw_path_from_dist(dist: torch.Tensor, n1: torch.Tensor,
                       n2: torch.Tensor) -> torch.Tensor:
    """Alignment-path mask A (B, T1, T2) float32 from a distance tensor:
    A[b, i, j] = 1 exactly on the backtrace-path cells, A.sum((1, 2)) is
    the path length. A CUDA tensor runs the hand-written kernel, a CPU
    tensor the plain version."""
    from abnet3_torch.ops import cuda_dtw
    if dist.is_cuda:
        return cuda_dtw.dtw_path_cuda(dist.float().contiguous(),
                                      n1.to(torch.int32).contiguous(),
                                      n2.to(torch.int32).contiguous())
    return cuda_dtw.dtw_path_plain(dist, n1, n2)


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
