"""The train-step factories of the bank, frame-table and padded pair
batches.

The counterpart of ``abnet3_tpu/parallel/mesh.py`` (same file name, so
the two are easy to pair) on one device: no mesh, no multitask labels,
and no K-chaining (a dispatch trick of jit; the trainer keeps its step
order instead). Each factory returns steps that take the batch's tensors
on the network's device and return the loss as a 0-d device tensor; a
train step also updates the parameters (``optimizer``) and the
batch-norm buffers in place.

- :func:`make_split_pair_train_step`: static same/diff groups
  (``SplitBankBatch``), the flagship step;
- :func:`make_pair_train_step`: mixed same/diff pairs (``BankBatch``),
  every pair aligned by DTW and by truncation, selected per pair by its
  label;
- both take an optional temporal-coherence group (``frame_bank`` and
  ``tcl > 0``): frame pairs gathered from the frame table, with weights
  rescaled so that the group carries exactly tcl/(1-tcl) of the token
  pairs' total weight (reference dataloader.py:314-322);
- :func:`make_frame_train_step`: frame-index batches against a device
  frame table (``FrameBankBatch``);
- :func:`make_fused_train_step`: raw padded same/diff token batches;
- :func:`make_frame_pair_steps`: aligned frame pairs (``Batch``).

In matrix mode (the default where the loss has a cell decomposition) a
token step:

1. gathers the token frames at the batch's length bucket;
2. computes the angular distances and the DTW path masks (the
   hand-written kernel on the card) under ``torch.no_grad()``: the masks
   depend on the input features only, never on the parameters;
3. embeds every frame of the batch exactly once, with per-frame visit
   counts as batch-norm weights;
4. reduces the loss over the mask-weighted embedding cosines.

In gather mode (``matrix_loss=False``) the same pairs are aligned by DTW
path indices instead (the move kernel on the card, then the backtrace
walk), the different pairs by truncation or diagonal stretch, the aligned
frames gathered, and the frame-pair step of :func:`make_frame_pair_steps`
runs on them. The two modes give the same loss (the visit counts of
matrix mode are the batch-norm weights of the gathered rows).
"""

from __future__ import annotations

from typing import Optional

import torch

from abnet3_torch.ops.dtw import (align_diff_batch, aligned_frame_pairs,
                                  dtw_align_from_dist, dtw_path_from_dist,
                                  gather_aligned, pairwise_angular_distance)

__all__ = ["make_split_pair_train_step", "make_pair_train_step",
           "make_frame_train_step", "make_fused_train_step",
           "make_frame_pair_steps", "use_matrix_loss"]


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


def _diff_mask(n1, n2, wd, T1: int, T2: int,
               align_different_words: bool) -> torch.Tensor:
    """(B, T1, T2) alignment mask of different-word pairs: the diagonal
    prefix up to min(n1, n2) (truncate mode), or the stretched diagonal
    (``align_different_words``), times the per-pair weight."""
    if not align_different_words:
        dev = wd.device
        ii = torch.arange(T1, device=dev)[None, :, None]
        jj = torch.arange(T2, device=dev)[None, None, :]
        minlen = torch.minimum(n1, n2)[:, None, None]
        return ((ii == jj) & (ii < minlen)).float() * wd[:, None, None]
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
        A_d = _diff_mask(n1d, n2d, wd, T1d, T2d, True)
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
    """Flattened (cells, y, weights) loss terms of embeddings laid out
    [e1s; e2s; e1d; e2d; rest]: the same pairs' cosine cells under the
    DTW mask (y=+1), the diff pairs' under the stretched-diagonal mask or,
    in truncate mode, their diagonal rows (y=-1). Returns the terms and
    the leftover rows (tcl frames appended by the caller)."""
    A_d = A_d_parts[0]
    e1s, e2s, e1d, e2d, rest = _split_group_rows(e, A_s, A_d_parts)
    c_s = cell_loss.pair_cells(e1s, e2s)
    if A_d.dim() == 3:  # stretch mode: full mask
        c_d = cell_loss.pair_cells(e1d, e2d)
    else:               # truncate mode: diagonal only
        Tm = A_d.shape[1]
        d = e1d.shape[-1]
        c_d = cell_loss.rowwise_cells(e1d[:, :Tm].reshape(-1, d),
                                      e2d[:, :Tm].reshape(-1, d))
    dev = e.device
    c = torch.cat([c_s.reshape(-1), c_d.reshape(-1)])
    y = torch.cat([torch.ones(A_s.numel(), device=dev),
                   -torch.ones(A_d.numel(), device=dev)])
    w = torch.cat([A_s.reshape(-1), A_d.reshape(-1)])
    return c, y, w, rest


def _tcl_weights(tw, tcl: float, token_weight):
    """The tcl group's weights rescaled to exactly tcl/(1-tcl) of the
    token pairs' total weight ``token_weight`` (no gradient: the weights
    come from the batch and the alignment masks)."""
    return tw * (tcl / (1.0 - tcl)) * (
        token_weight / torch.clamp(torch.sum(tw), min=1e-6))


def _with_tcl_pairs(pairs, tcl_args, frame_bank, tcl: float):
    """Gather mode: the tcl group's frame pairs appended to the token
    frame pairs (x1, x2, y, w)."""
    if tcl_args is None:
        return pairs
    x1, x2, y, w = pairs
    ti1, ti2, ty, tw = tcl_args
    return (torch.cat([x1, frame_bank[ti1]]), torch.cat([x2, frame_bank[ti2]]),
            torch.cat([y, ty]),
            torch.cat([w, _tcl_weights(tw, tcl, torch.sum(w))]))


def _with_tcl_frames(frames, w_frames, tcl_args, frame_bank, tcl: float,
                     token_weight):
    """Matrix mode: the tcl group's frames appended to the unique-frame
    batch, each side weighted by the pair's weight in the batch norm.
    Returns (frames, w_frames, tcl_terms) with tcl_terms (y, w, n) or
    None."""
    if tcl_args is None:
        return frames, w_frames, None
    ti1, ti2, ty, tw = tcl_args
    wt = _tcl_weights(tw, tcl, token_weight)
    return (torch.cat([frames, frame_bank[ti1], frame_bank[ti2]]),
            torch.cat([w_frames, wt, wt]), (ty, wt, ti1.shape[0]))


def _with_tcl_cells(loss, c, y, w, rest, tcl_terms):
    """The tcl pairs' row-wise cells (from the embedding rows ``rest``
    after the token frames) appended to the loss terms (c, y, w)."""
    if tcl_terms is None:
        return c, y, w
    ty, wt, n_tcl = tcl_terms
    ct = loss.rowwise_cells(rest[:n_tcl], rest[n_tcl:])
    return torch.cat([c, ct]), torch.cat([y, ty]), torch.cat([w, wt])


def _check_tcl(frame_bank, tcl: float):
    if frame_bank is not None and not 0 < tcl < 1:
        raise ValueError(f"a frame bank needs 0 < tcl < 1, got {tcl}")


def _split_tcl(args, frame_bank):
    """(token args, tcl args or None) of a step's arguments: with a frame
    bank the last four are the tcl group (i1, i2, y, w)."""
    if frame_bank is None:
        return args, None
    return args[:-4], args[-4:]


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


def _gather_steps(network, loss, optimizer, prepare):
    """(train_step, eval_step) of a gather mode: ``prepare(*args)`` (run
    under ``torch.no_grad()``) assembles the frame pairs (x1, x2, y, w)
    that the frame-pair step then takes."""
    frame_train, frame_eval = make_frame_pair_steps(network, loss,
                                                    optimizer)
    prepare = torch.no_grad()(prepare)

    def train_step(*args):
        return frame_train(*prepare(*args))

    def eval_step(*args):
        return frame_eval(*prepare(*args))

    return train_step, eval_step


def _matrix_steps(network, optimizer, prepare, value):
    """(train_step, eval_step) of a matrix mode: ``prepare(*args)`` (run
    under ``torch.no_grad()``) assembles the parts that do not depend on
    the parameters, ``value(parts)`` computes the loss from them."""
    prepare = torch.no_grad()(prepare)

    def train_step(*args):
        parts = prepare(*args)
        network.train()
        optimizer.zero_grad(set_to_none=True)
        v = value(parts)
        v.backward()
        optimizer.step()
        return v.detach()

    @torch.no_grad()
    def eval_step(*args):
        network.eval()
        return value(prepare(*args))

    return train_step, eval_step


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
                               matrix_loss: Optional[bool] = None,
                               frame_bank=None, tcl: float = 0.0):
    """Train/eval steps over SplitBankBatch index batches (static
    same/diff groups). Returns (train_step, eval_step); both take the
    device tensors (ids1s, ids2s, ws, ids1d, ids2d, wd) and, with a
    ``frame_bank`` (tcl > 0), the tcl group (i1, i2, y, w).
    ``max_frames`` is the batch's length bucket. ``matrix_loss`` picks
    the mode (see :func:`use_matrix_loss`)."""
    _check_tcl(frame_bank, tcl)
    Tb = max_frames if max_frames is not None else bank.max_len

    if not use_matrix_loss(loss, matrix_loss):
        def align(*args):
            args, tcl_args = _split_tcl(args, frame_bank)
            return _with_tcl_pairs(
                _split_bank_align(bank, *args, align_different_words, Tb),
                tcl_args, frame_bank, tcl)

        return _gather_steps(network, loss, optimizer, align)

    def matrix_parts(*args):
        args, tcl_args = _split_tcl(args, frame_bank)
        ids1s, ids2s, ws, ids1d, ids2d, wd = args
        f1s, n1s = bank.take(ids1s, Tb)
        f2s, n2s = bank.take(ids2s, Tb)
        f1d, n1d = bank.take(ids1d, Tb)
        f2d, n2d = bank.take(ids2d, Tb)
        frames, w_frames, A_s, A_d_parts = _matrix_same_diff_parts(
            f1s, f2s, n1s, n2s, ws, f1d, f2d, n1d, n2d, wd,
            align_different_words)
        frames, w_frames, tcl_terms = _with_tcl_frames(
            frames, w_frames, tcl_args, frame_bank, tcl,
            A_s.sum() + A_d_parts[0].sum())
        return frames, w_frames, A_s, A_d_parts, tcl_terms

    def matrix_value(parts):
        frames, w_frames, A_s, A_d_parts, tcl_terms = parts
        e = network.forward_once(frames, weights=w_frames)
        A_d = A_d_parts[0]
        if A_d.dim() == 3:  # stretch mode: full diff mask
            c, y, w, rest = _matrix_cell_terms(loss, e, A_s, A_d_parts)
            c, y, w = _with_tcl_cells(loss, c, y, w, rest, tcl_terms)
            return loss.from_cells(c, y, weights=w)
        # truncate mode: the same-group loss is affine in the cosine, so
        # it folds into masked matmuls; only the diff diagonal (and the
        # tcl pairs) stay elementwise
        e1s, e2s, e1d, e2d, rest = _split_group_rows(e, A_s, A_d_parts)
        same_sum = loss.masked_same_sum(e1s, e2s, A_s)
        Tm = A_d.shape[1]
        d_e = e1d.shape[-1]
        c_rest = loss.rowwise_cells(e1d[:, :Tm].reshape(-1, d_e),
                                    e2d[:, :Tm].reshape(-1, d_e))
        c_rest, y_rest, w_rest = _with_tcl_cells(
            loss, c_rest, -torch.ones(A_d.numel(), device=e.device),
            A_d.reshape(-1), rest, tcl_terms)
        return loss.from_parts(same_sum, torch.sum(A_s), c_rest, y_rest,
                               w_rest)

    return _matrix_steps(network, optimizer, matrix_parts, matrix_value)


def _bank_align(bank, ids1, ids2, y_pair, pair_w,
                align_different_words: bool, T: int):
    """Mixed-pair gather assembly: every pair is DTW-aligned and
    truncate/diagonal-aligned, both at L = 2T-1, and the label selects
    the path per pair. Returns flattened (x1, x2, y, w) frame pairs of
    static shape (B * (2T-1), ...)."""
    f1, n1 = bank.take(ids1, T)
    f2, n2 = bank.take(ids2, T)
    T = f1.shape[1]
    L = 2 * T - 1
    dist = pairwise_angular_distance(f1, f2)
    p1s, p2s, plen_s = dtw_align_from_dist(dist, n1, n2)
    p1d, p2d, plen_d = align_diff_batch(
        n1, n2, T, T, align_different_words=align_different_words, L=L)
    same = (y_pair > 0)[:, None]
    p1 = torch.where(same, p1s, p1d)
    p2 = torch.where(same, p2s, p2d)
    plen = torch.where(y_pair > 0, plen_s.to(plen_d.dtype), plen_d)
    x1 = gather_aligned(f1, p1)
    x2 = gather_aligned(f2, p2)
    w = ((torch.arange(L, device=f1.device)[None, :] < plen[:, None])
         .float() * pair_w[:, None])
    d = x1.shape[-1]
    yb = y_pair[:, None].expand(y_pair.shape[0], L)
    return (x1.reshape(-1, d), x2.reshape(-1, d), yb.reshape(-1),
            w.reshape(-1))


def _bank_align_matrix(bank, ids1, ids2, y_pair, pair_w,
                       align_different_words: bool, T: int):
    """Matrix-mode twin of :func:`_bank_align`: every pair gets a (T, T)
    alignment mask — the DTW path mask for same pairs, the
    truncate/diagonal path for diff pairs — selected per pair by the
    label. Returns (frames, w_frames, A, y_cells) with frames = [f1; f2],
    each token exactly once."""
    f1, n1 = bank.take(ids1, T)
    f2, n2 = bank.take(ids2, T)
    T = f1.shape[1]
    dist = pairwise_angular_distance(f1, f2)
    A_dtw = dtw_path_from_dist(dist, n1, n2)
    A_diff = _diff_mask(n1, n2, torch.ones_like(pair_w), T, T,
                        align_different_words)
    same = (y_pair > 0)[:, None, None]
    A = torch.where(same, A_dtw, A_diff) * pair_w[:, None, None]
    d = f1.shape[-1]
    frames = torch.cat([f1.reshape(-1, d), f2.reshape(-1, d)])
    w_frames = torch.cat([A.sum(2).reshape(-1), A.sum(1).reshape(-1)])
    y_cells = y_pair[:, None, None].expand(A.shape)
    return frames, w_frames, A, y_cells


def _head_cells(cell_loss, e, B, T1, T2):
    """Per-cell statistics of [e1; e2] rows via the loss's decomposition
    (loss.pair_cells)."""
    e1 = e[:B * T1].reshape(B, T1, -1)
    e2 = e[B * T1:].reshape(B, T2, -1)
    return cell_loss.pair_cells(e1, e2)


def make_pair_train_step(network, loss, optimizer, bank,
                         align_different_words: bool = False,
                         max_frames: int = None,
                         matrix_loss: Optional[bool] = None,
                         frame_bank=None, tcl: float = 0.0):
    """Train/eval steps over BankBatch index batches of mixed pairs:
    every pair is (id1, id2, y, pair_weight); same-word pairs (y=+1) are
    DTW-aligned, diff-word pairs (y=-1) truncate/diagonal-aligned,
    selected per pair; padded pairs weigh 0. Returns (train_step,
    eval_step); both take (ids1, ids2, y, pair_w) and, with a
    ``frame_bank`` (tcl > 0), the tcl group (i1, i2, y, w). In matrix
    mode every pair's DP runs in the path-mask kernel, in gather mode in
    the move kernel."""
    _check_tcl(frame_bank, tcl)
    T = max_frames if max_frames is not None else bank.max_len

    if not use_matrix_loss(loss, matrix_loss):
        def gather_prepare(*args):
            args, tcl_args = _split_tcl(args, frame_bank)
            return _with_tcl_pairs(
                _bank_align(bank, *args, align_different_words, T),
                tcl_args, frame_bank, tcl)

        return _gather_steps(network, loss, optimizer, gather_prepare)

    def matrix_prepare(*args):
        args, tcl_args = _split_tcl(args, frame_bank)
        frames, w_frames, A, y_cells = _bank_align_matrix(
            bank, *args, align_different_words, T)
        n_tok = frames.shape[0]
        frames, w_frames, tcl_terms = _with_tcl_frames(
            frames, w_frames, tcl_args, frame_bank, tcl, A.sum())
        return frames, w_frames, A, y_cells, n_tok, tcl_terms

    def matrix_value(parts):
        frames, w_frames, A, y_cells, n_tok, tcl_terms = parts
        B, T1, T2 = A.shape
        e = network.forward_once(frames, weights=w_frames)
        cells = _head_cells(loss, e[:n_tok], B, T1, T2)
        if tcl_terms is None:
            return loss.from_cells(cells, y_cells, weights=A)
        c, y, w = _with_tcl_cells(loss, cells.reshape(-1),
                                  y_cells.reshape(-1), A.reshape(-1),
                                  e[n_tok:], tcl_terms)
        return loss.from_cells(c, y, weights=w)

    return _matrix_steps(network, optimizer, matrix_prepare, matrix_value)


def make_frame_train_step(network, loss, optimizer, tables,
                          multimodal: bool = False):
    """Train/eval steps over FrameBankBatch index batches against a
    device frame table: both take (i1, i2, y, w), gather X1 = table[i1]
    and X2 = table[i2] and run the frame-pair step; weight-0 rows stay
    out of the loss and the batch-norm statistics. ``tables`` holds one
    (N, d) tensor; several modalities (``multimodal=True``) are not
    ported yet."""
    if multimodal:
        raise NotImplementedError(
            "multimodal frame tables (MultimodalDataLoader) are not ported "
            "to abnet3_torch yet (ROADMAP.md A10)")
    (table,) = tuple(tables)

    def gather(i1, i2, y, w):
        return table[i1], table[i2], y, w

    return _gather_steps(network, loss, optimizer, gather)


def _align_and_flatten(f1s, f2s, n1s, n2s, f1d, f2d, n1d, n2d):
    """The fused gather step's batch: the same pairs DTW-aligned (L =
    T1+T2-1), the diff pairs truncated (L = max(T1, T2)), gathered and
    flattened into frame pairs (x1, x2, y, w) with padding weights."""
    same = aligned_frame_pairs(f1s, f2s, n1s, n2s, True)
    diff = aligned_frame_pairs(f1d, f2d, n1d, n2d, False)
    return tuple(torch.cat(parts) for parts in zip(same, diff))


def make_fused_train_step(network, loss, optimizer,
                          matrix_loss: Optional[bool] = None):
    """One train step over raw padded pair batches: f1s, f2s (Bs, Ts, d)
    and n1s, n2s (Bs,) same-word pairs (DTW-aligned); f1d, f2d (Bd, Td, d)
    and n1d, n2d (Bd,) diff-word pairs (truncated). Returns
    ``train_step(f1s, f2s, n1s, n2s, f1d, f2d, n1d, n2d)``, which aligns,
    embeds, takes the loss and updates the network in place, and returns
    the loss. Matrix mode (see :func:`use_matrix_loss`) weighs the
    embedding cosines by the path masks (the path kernel on the card);
    gather mode gathers the frames along the walked paths (the move
    kernel)."""
    if not use_matrix_loss(loss, matrix_loss):
        return _gather_steps(network, loss, optimizer,
                             _align_and_flatten)[0]

    def parts(f1s, f2s, n1s, n2s, f1d, f2d, n1d, n2d):
        ws = torch.ones(f1s.shape[0], device=f1s.device)
        wd = torch.ones(f1d.shape[0], device=f1d.device)
        return _matrix_same_diff_parts(f1s, f2s, n1s, n2s, ws,
                                       f1d, f2d, n1d, n2d, wd, False)

    def value(p):
        frames, w_frames, A_s, A_d_parts = p
        e = network.forward_once(frames, weights=w_frames)
        c, y, w, _ = _matrix_cell_terms(loss, e, A_s, A_d_parts)
        return loss.from_cells(c, y, weights=w)

    return _matrix_steps(network, optimizer, parts, value)[0]
