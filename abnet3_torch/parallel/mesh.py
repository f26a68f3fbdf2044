"""The train-step factories of the split same/diff bank batches and of
aligned frame-pair batches.

The counterpart of ``abnet3_tpu/parallel/mesh.py`` (same file name, so
the two are easy to pair), for ``make_split_pair_train_step`` on one
device: no mesh, no temporal-coherence group, no multitask labels, and no
K-chaining (a dispatch trick of jit; the trainer keeps its step order
instead). In matrix mode (the default where the loss has a cell
decomposition) each step:

1. gathers the same-group and diff-group token frames from the
   :class:`~abnet3_torch.ops.bank.TokenBank` at the batch's length bucket;
2. computes the angular distances of the same pairs and their DTW path
   masks (the hand-written kernel on the card) under ``torch.no_grad()``:
   the mask depends on the input features only, never on the parameters;
3. embeds every frame of the batch exactly once, with per-frame visit
   counts as batch-norm weights;
4. reduces the loss over the mask-weighted embedding cosines (the
   same-group part folded into matmuls by ``loss.masked_same_sum``, the
   truncated diff diagonal row by row).

Autograd covers the tower and the loss.

In gather mode (``matrix_loss=False``) the step aligns the same pairs by
DTW path indices instead (the move kernel on the card, then the
backtrace walk), the different pairs by truncation or diagonal stretch,
gathers the aligned frames, and runs the frame-pair step of
:func:`make_frame_pair_steps`, the step the trainer also runs on the
device loader's batches. The two modes give the same loss (the visit
counts of matrix mode are the batch-norm weights of the gathered rows).
"""

from __future__ import annotations

from typing import Optional

import torch

from abnet3_torch.ops.dtw import (align_diff_batch, aligned_frame_pairs,
                                  dtw_path_from_dist,
                                  pairwise_angular_distance)

__all__ = ["make_split_pair_train_step", "make_frame_pair_steps",
           "use_matrix_loss"]


def use_matrix_loss(loss, override: Optional[bool] = None) -> bool:
    """Whether a step takes the matrix-loss path: ``override`` when
    given, else whenever the loss has a cell decomposition; otherwise it
    takes the gather path."""
    if override is not None:
        return bool(override)
    return getattr(loss, "supports_cells", False)


def _diff_path_mask(p1d, p2d, plen_d, wd, T1: int, T2: int) -> torch.Tensor:
    """Scatter a diff-pair alignment path (diagonal-stretch mode) into a
    (B, T1, T2) mask weighted by the per-pair weight."""
    B, L = p1d.shape
    dmask = ((torch.arange(L, device=wd.device)[None, :] < plen_d[:, None])
             .float() * wd[:, None])
    A = torch.zeros((B, T1, T2), dtype=torch.float32, device=wd.device)
    rows = torch.arange(B, device=wd.device)[:, None].expand(B, L)
    return A.index_put_((rows, p1d, p2d), dmask, accumulate=True)


def _diff_mask(n1, n2, wd, T1: int, T2: int) -> torch.Tensor:
    """(B, T1, T2) alignment mask of different-word pairs in
    diagonal-stretch mode (align_different_words=True)."""
    p1d, p2d, plen_d = align_diff_batch(n1, n2, T1, T2,
                                        align_different_words=True)
    return _diff_path_mask(p1d, p2d, plen_d, wd, T1, T2)


def _matrix_same_diff_parts(f1s, f2s, n1s, n2s, ws, f1d, f2d, n1d, n2d, wd,
                            align_different_words: bool):
    """The unique-frame batch (every frame exactly once), per-frame
    visit-count weights (the batch-norm weights), and the same/diff
    alignment masks that weight the cosine matrices in the loss. In
    truncate mode the diff alignment is the diagonal prefix up to
    min(n1, n2), kept as a (B, Tmin) weight row."""
    dist = pairwise_angular_distance(f1s, f2s)
    A_s = dtw_path_from_dist(dist, n1s, n2s) * ws[:, None, None]
    T1d, T2d = f1d.shape[1], f2d.shape[1]
    d = f1s.shape[-1]
    if align_different_words:
        A_d = _diff_mask(n1d, n2d, wd, T1d, T2d)
        w1d, w2d = A_d.sum(2), A_d.sum(1)
    else:
        Tm = min(T1d, T2d)
        minlen = torch.minimum(n1d, n2d)
        A_d = ((torch.arange(Tm, device=wd.device)[None, :]
                < minlen[:, None]).float() * wd[:, None])
        w1d = torch.nn.functional.pad(A_d, (0, T1d - Tm))
        w2d = torch.nn.functional.pad(A_d, (0, T2d - Tm))
    frames = torch.cat([f1s.reshape(-1, d), f2s.reshape(-1, d),
                        f1d.reshape(-1, d), f2d.reshape(-1, d)])
    w_frames = torch.cat([A_s.sum(2).reshape(-1), A_s.sum(1).reshape(-1),
                          w1d.reshape(-1), w2d.reshape(-1)])
    return frames, w_frames, A_s, (A_d, T1d, T2d)


def _split_group_rows(e, A_s, A_d_parts):
    """Split the unique-frame embedding rows [e1s; e2s; e1d; e2d; rest]
    back into per-group (B, T, E) tensors."""
    A_d, T1d, T2d = A_d_parts
    Bs, T1s, T2s = A_s.shape
    Bd = A_d.shape[0]
    i = 0
    e1s = e[i:i + Bs * T1s].reshape(Bs, T1s, -1); i += Bs * T1s
    e2s = e[i:i + Bs * T2s].reshape(Bs, T2s, -1); i += Bs * T2s
    e1d = e[i:i + Bd * T1d].reshape(Bd, T1d, -1); i += Bd * T1d
    e2d = e[i:i + Bd * T2d].reshape(Bd, T2d, -1); i += Bd * T2d
    return e1s, e2s, e1d, e2d, e[i:]


def _matrix_cell_terms(cell_loss, e, A_s, A_d_parts):
    """Flattened (cells, y, weights) loss terms of the stretch mode: the
    same pairs' cosine cells under the DTW mask (y=+1) and the diff
    pairs' under the stretched-diagonal mask (y=-1)."""
    A_d = A_d_parts[0]
    e1s, e2s, e1d, e2d, _ = _split_group_rows(e, A_s, A_d_parts)
    c_s = cell_loss.pair_cells(e1s, e2s)
    c_d = cell_loss.pair_cells(e1d, e2d)
    dev = e.device
    c = torch.cat([c_s.reshape(-1), c_d.reshape(-1)])
    y = torch.cat([torch.ones(A_s.numel(), device=dev),
                   -torch.ones(A_d.numel(), device=dev)])
    w = torch.cat([A_s.reshape(-1), A_d.reshape(-1)])
    return c, y, w


def make_frame_pair_steps(network, loss, optimizer):
    """Train/eval steps over aligned frame pairs (the JAX trainer's
    frame-pair step, and the gather mode's body). Both take x1, x2 (N, d),
    y (N,) and weights w (N,) on the network's device and return the loss
    as a 0-d device tensor; ``w`` weighs the loss and, in training, the
    batch-norm statistics. ``train_step`` also updates the parameters
    (``optimizer``) and batch-norm buffers in place."""

    def train_step(x1, x2, y, w):
        network.train()
        optimizer.zero_grad(set_to_none=True)
        e1, e2 = network.forward(x1, x2, weights=w)
        value = loss(e1, e2, y, weights=w)
        value.backward()
        optimizer.step()
        return value.detach()

    @torch.no_grad()
    def eval_step(x1, x2, y, w):
        network.eval()
        e1, e2 = network.forward(x1, x2)
        return loss(e1, e2, y, weights=w)

    return train_step, eval_step


@torch.no_grad()
def _split_bank_align(bank, ids1s, ids2s, ws, ids1d, ids2d, wd,
                      align_different_words: bool, T: int):
    """Gather-mode batch assembly: the same group aligned by DTW (paths of
    2T-1 steps), the different group by truncation or diagonal stretch
    (T steps), both gathered and flattened into frame pairs (x1, x2, y,
    w) whose weights mask each path's padding and each pair's weight."""
    f1s, n1s = bank.take(ids1s, T)
    f2s, n2s = bank.take(ids2s, T)
    f1d, n1d = bank.take(ids1d, T)
    f2d, n2d = bank.take(ids2d, T)
    same = aligned_frame_pairs(f1s, f2s, n1s, n2s, True, pair_w=ws)
    diff = aligned_frame_pairs(f1d, f2d, n1d, n2d, False,
                               align_different_words, pair_w=wd)
    return tuple(torch.cat(parts) for parts in zip(same, diff))


def make_split_pair_train_step(network, loss, optimizer, bank,
                               align_different_words: bool = False,
                               max_frames: int = None,
                               matrix_loss: Optional[bool] = None):
    """Train/eval steps over SplitBankBatch index batches (static
    same/diff groups). Returns (train_step, eval_step); both take the
    device tensors (ids1s, ids2s, ws, ids1d, ids2d, wd) and return the
    batch loss as a 0-d device tensor. ``train_step`` also updates the
    network's parameters (``optimizer``) and batch-norm buffers in place.
    ``max_frames`` is the batch's length bucket. ``matrix_loss`` picks
    the mode (see :func:`use_matrix_loss`)."""
    Tb = max_frames if max_frames is not None else bank.max_len
    if not use_matrix_loss(loss, matrix_loss):
        frame_train, frame_eval = make_frame_pair_steps(network, loss,
                                                        optimizer)

        def align(*args):
            return _split_bank_align(bank, *args, align_different_words, Tb)

        def gather_train_step(*args):
            return frame_train(*align(*args))

        def gather_eval_step(*args):
            return frame_eval(*align(*args))

        return gather_train_step, gather_eval_step

    @torch.no_grad()
    def matrix_parts(ids1s, ids2s, ws, ids1d, ids2d, wd):
        f1s, n1s = bank.take(ids1s, Tb)
        f2s, n2s = bank.take(ids2s, Tb)
        f1d, n1d = bank.take(ids1d, Tb)
        f2d, n2d = bank.take(ids2d, Tb)
        return _matrix_same_diff_parts(f1s, f2s, n1s, n2s, ws,
                                       f1d, f2d, n1d, n2d, wd,
                                       align_different_words)

    def matrix_value(parts):
        frames, w_frames, A_s, A_d_parts = parts
        e = network.forward_once(frames, weights=w_frames)
        A_d = A_d_parts[0]
        if A_d.dim() == 3:  # stretch mode: full diff mask
            c, y, w = _matrix_cell_terms(loss, e, A_s, A_d_parts)
            return loss.from_cells(c, y, weights=w)
        # truncate mode: the same-group loss is affine in the cosine, so
        # it folds into masked matmuls; only the diff diagonal stays
        # elementwise
        e1s, e2s, e1d, e2d, _ = _split_group_rows(e, A_s, A_d_parts)
        same_sum = loss.masked_same_sum(e1s, e2s, A_s)
        Tm = A_d.shape[1]
        d_e = e1d.shape[-1]
        c_rest = loss.rowwise_cells(e1d[:, :Tm].reshape(-1, d_e),
                                    e2d[:, :Tm].reshape(-1, d_e))
        y_rest = -torch.ones(A_d.numel(), device=e.device)
        return loss.from_parts(same_sum, torch.sum(A_s), c_rest, y_rest,
                               A_d.reshape(-1))

    def train_step(*args):
        parts = matrix_parts(*args)
        network.train()
        optimizer.zero_grad(set_to_none=True)
        value = matrix_value(parts)
        value.backward()
        optimizer.step()
        return value.detach()

    @torch.no_grad()
    def eval_step(*args):
        network.eval()
        return matrix_value(matrix_parts(*args))

    return train_step, eval_step
