"""DTW of frame sequences under the angular distance, plainly.

The recurrence D[i, j] = d[i, j] + min(D[i-1, j], D[i, j-1],
D[i-1, j-1]) from D[0, 0] = d[0, 0], one anti-diagonal at a time;
the path is the chain of argmin moves walked back from (n1-1, n2-1),
ties going to the diagonal, then up (i-1), then left (j-1). The path
length rides the same chain.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from h100_bench.reference import numerics

BIG = 1e30


def angular_distance(x: torch.Tensor, y: torch.Tensor,
                     cos_dtype=torch.float32) -> torch.Tensor:
    """arccos(cos)/pi of every frame pair: x (B, T1, d), y (B, T2, d) ->
    (B, T1, T2) float32. Zero frames (padding) are at distance 1 from all
    but other zero frames. ``cos_dtype`` float64 takes the cosines of
    unit frames in double precision before rounding them to float32."""
    x, y = x.to(cos_dtype), y.to(cos_dtype)
    nx = torch.sqrt((x * x).sum(-1))
    ny = torch.sqrt((y * y).sum(-1))
    zx, zy = nx == 0, ny == 0
    xu = x / torch.where(zx, 1.0, nx)[..., None]
    yu = y / torch.where(zy, 1.0, ny)[..., None]
    cos = numerics.bmm(xu, yu.transpose(1, 2)).float().clamp(-1.0, 1.0)
    d = torch.arccos(cos) / math.pi
    d = torch.where(zx[:, :, None] | zy[:, None, :], 1.0, d)
    return torch.where(zx[:, :, None] & zy[:, None, :], 0.0, d)


def dp(d: torch.Tensor, n1: torch.Tensor, n2: torch.Tensor):
    """(endpoint cost (B,), path length (B,), moves (B, T1, T2) int8 with
    3 diag, 2 up, 1 left) of distances d (B, T1, T2)."""
    B, T1, T2 = d.shape
    dev = d.device
    D = torch.full((B, T1, T2), BIG, dtype=torch.float32, device=dev)
    L = torch.zeros((B, T1, T2), dtype=torch.int32, device=dev)
    M = torch.zeros((B, T1, T2), dtype=torch.int8, device=dev)
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)
    for k in range(T1 + T2 - 1):
        j = torch.arange(max(0, k - T1 + 1), min(k, T2 - 1) + 1, device=dev)
        i = k - j
        c = d[:, i, j]
        if k == 0:
            D[:, 0, 0] = c[:, 0]
            L[:, 0, 0] = 1
            continue
        im, jm = (i - 1).clamp(min=0), (j - 1).clamp(min=0)
        up = torch.where(i >= 1, D[:, im, j], big)
        left = torch.where(j >= 1, D[:, i, jm], big)
        diag = torch.where((i >= 1) & (j >= 1), D[:, im, jm], big)
        take_diag = (diag <= up) & (diag <= left)
        take_up = ~take_diag & (up <= left)
        D[:, i, j] = c + torch.minimum(torch.minimum(diag, up), left)
        L[:, i, j] = 1 + torch.where(
            take_diag, L[:, im, jm], torch.where(take_up, L[:, im, j],
                                                 L[:, i, jm]))
        M[:, i, j] = torch.where(take_diag, 3, torch.where(take_up, 2, 1)
                                 ).to(torch.int8)
    b = torch.arange(B, device=dev)
    e1, e2 = n1.long() - 1, n2.long() - 1
    return D[b, e1, e2], L[b, e1, e2], M


def path_cells(moves: torch.Tensor, n1, n2) -> List[Tuple[np.ndarray,
                                                         np.ndarray]]:
    """Each pair's path as (i, j) index arrays from (0, 0) to its end."""
    mv = moves.cpu().numpy()
    out = []
    for b, (a, c) in enumerate(zip(np.asarray(n1).tolist(),
                                   np.asarray(n2).tolist())):
        i, j = a - 1, c - 1
        ii, jj = [i], [j]
        while i > 0 or j > 0:
            m = mv[b, i, j]
            i, j = max(i - (m >> 1), 0), max(j - (m & 1), 0)
            ii.append(i)
            jj.append(j)
        out.append((np.asarray(ii[::-1]), np.asarray(jj[::-1])))
    return out


def pad(tokens: List[np.ndarray], device) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Zero-padded (B, T, d) float32 frames and their (B,) lengths."""
    T = max(len(t) for t in tokens)
    out = np.zeros((len(tokens), T, tokens[0].shape[1]), np.float32)
    for k, t in enumerate(tokens):
        out[k, :len(t)] = t
    n = torch.tensor([len(t) for t in tokens], device=device)
    return torch.from_numpy(out).to(device), n


def mean_path_distance(x1: torch.Tensor, n1, x2: torch.Tensor, n2,
                       cos_dtype=torch.float64) -> torch.Tensor:
    """The DTW distance of token pairs: the angular distances summed along
    the path over its length, (B,) float32."""
    cost, length, _ = dp(angular_distance(x1, x2, cos_dtype), n1, n2)
    return cost / length.clamp(min=1).float()
