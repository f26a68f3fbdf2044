"""The ABX error of a distance matrix, plainly (ZeroSpeech's definition).

For A and B of one class and X of another, the triplet is an error when
d(A, X) < d(A, B), half an error when they are equal. Across speakers: a
cell per (class of A, class of X), B of A's class from another speaker,
X from A's speaker. Within: a cell per (class of A, class of X,
speaker), A, B and X all from that speaker, B not A. A cell's score is
its error over its triplets; the result is the mean over the cells that
have triplets. Anchors run in blocks against every token at once, on
whichever device holds the matrix.
"""

from __future__ import annotations

import torch


def abx_error(D: torch.Tensor, labels: torch.Tensor, speakers: torch.Tensor,
              task: str = "across", block: int = 128,
              dtype=torch.float64) -> dict:
    """{error, n_cells, n_triplets}; the cells' sums accumulate in
    ``dtype`` (float32 for the control)."""
    assert task in ("across", "within")
    N = D.shape[0]
    dev = D.device
    lab = torch.unique(labels, return_inverse=True)[1].to(dev)
    spk = torch.unique(speakers, return_inverse=True)[1].to(dev)
    C, S = int(lab.max()) + 1, int(spk.max()) + 1
    n_cells = C * C * (S if task == "within" else 1)
    err = torch.zeros(n_cells, dtype=dtype, device=dev)
    cnt = torch.zeros(n_cells, dtype=dtype, device=dev)
    idx = torch.arange(N, device=dev)
    for a0 in range(0, N, block):
        a = idx[a0:a0 + block]
        rows = D[a].float()                                  # (m, N)
        same_lab = lab[None, :] == lab[a][:, None]
        same_spk = spk[None, :] == spk[a][:, None]
        if task == "across":
            bmask = same_lab & ~same_spk
        else:
            bmask = same_lab & same_spk & (idx[None, :] != a[:, None])
        xmask = same_spk & ~same_lab
        kb = int(bmask.sum(1).max())
        if kb == 0:
            continue
        # each anchor's B tokens first, in index order
        order = torch.argsort((~bmask).to(torch.int8), dim=1, stable=True)
        bidx = order[:, :kb]
        bval = torch.gather(bmask, 1, bidx)
        dab = torch.gather(rows, 1, bidx)                    # (m, kb)
        gt = (dab[:, :, None] > rows[:, None, :]) & bval[:, :, None]
        eq = (dab[:, :, None] == rows[:, None, :]) & bval[:, :, None]
        e = (gt.sum(1).to(dtype) + 0.5 * eq.sum(1).to(dtype)) * xmask
        c = bval.sum(1, keepdim=True).to(dtype) * xmask      # (m, N)
        cell = lab[a][:, None] * C + lab[None, :]
        if task == "within":
            cell = cell * S + spk[a][:, None]
        cell = cell.expand(-1, N)
        err.index_add_(0, cell[xmask], e[xmask])
        cnt.index_add_(0, cell[xmask], c[xmask])
    have = cnt > 0
    scores = err[have] / cnt[have]
    return {"error": float(scores.mean()) if len(scores) else float("nan"),
            "n_cells": int(have.sum()), "n_triplets": int(cnt.sum())}
