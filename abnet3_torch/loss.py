"""Contrastive losses and their cell decomposition.

The counterpart of ``abnet3_tpu/loss.py``: ``coscos2`` and ``cosmargin``
(elementwise in the cosine), ``KLLoss`` (symmetric KL between
distributions, e.g. softmax outputs) and the multitask
``weighted_loss_multi``. The same math, with an optional per-example
``weights`` vector so padded frames of ragged device batches contribute
zero loss, and the cell hooks the matrix-mode train step
(:mod:`abnet3_torch.parallel.mesh`) reduces under the DTW path mask.

In a step sharded over a mesh's 'data' axis each rank holds a block of
the batch: a weighted mean then divides the rank's weighted sum by the
global weight sum (:func:`abnet3_torch.dist.global_sum`), so the
ranks' values (and gradients) add up to the global batch's.
"""

from __future__ import annotations

from typing import Optional

import torch

from abnet3_torch.dist import active, global_sum

__all__ = ["cosine_similarity", "normalize_rows", "coscos2_fn",
           "cosmargin_fn", "kl_loss_fn", "coscos2_from_cos",
           "cosmargin_from_cos", "LossBuilder", "coscos2", "cosmargin",
           "KLLoss", "weighted_loss_multi"]


def cosine_similarity(x1: torch.Tensor, x2: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    """Row-wise cosine similarity, torch.nn.CosineSimilarity semantics
    (each norm clamped at eps; reference loss.py:57-59)."""
    n1 = torch.sqrt(torch.sum(x1 * x1, dim=1))
    n2 = torch.sqrt(torch.sum(x2 * x2, dim=1))
    denom = torch.clamp(n1, min=eps) * torch.clamp(n2, min=eps)
    return torch.sum(x1 * x2, dim=1) / denom


def normalize_rows(e: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalise the last axis with the same eps clamp as
    :func:`cosine_similarity`, so dot products of normalised rows equal
    the row-wise cosine."""
    n = torch.sqrt(torch.sum(e * e, dim=-1, keepdim=True))
    return e / torch.clamp(n, min=eps)


def _pair_cos_matrix(e1: torch.Tensor, e2: torch.Tensor) -> torch.Tensor:
    """(B, T1, E) x (B, T2, E) -> (B, T1, T2) cosine matrix."""
    return torch.bmm(normalize_rows(e1), normalize_rows(e2).transpose(1, 2))


def _reduce(values: torch.Tensor, weights: Optional[torch.Tensor],
            avg: bool) -> torch.Tensor:
    if weights is not None:
        total = torch.sum(values * weights)
        if avg:
            return total / torch.clamp(global_sum(torch.sum(weights)),
                                       min=1.0)
        return total
    if avg:
        shard = active()
        if shard is not None and shard.data_group is not None:
            n = torch.tensor(float(values.numel()), device=values.device)
            return torch.sum(values) / global_sum(n)
        return torch.mean(values)
    return torch.sum(values)


def _coscos2_values(c, y):
    """same -> (1 - cos) / 2 ; diff -> cos^2 (reference loss.py:59-67)."""
    return torch.where(y > 0, (1.0 - c) / 2.0, c * c)


def _cosmargin_values(c, y, margin):
    """same -> 1 - cos ; diff -> max(0, cos - margin)
    (reference loss.py:97-105)."""
    return torch.where(y > 0, 1.0 - c, torch.clamp(c - margin, min=0.0))


def coscos2_from_cos(c, y, weights=None, avg=True):
    """coscos2 on precomputed cosine similarities of any shape (the loss
    is elementwise in the cosine)."""
    return _reduce(_coscos2_values(c, y), weights, avg)


def cosmargin_from_cos(c, y, margin=0.5, weights=None, avg=True):
    """cosmargin on precomputed cosine similarities of any shape."""
    return _reduce(_cosmargin_values(c, y, margin), weights, avg)


def coscos2_fn(input1, input2, y, weights=None, avg=True):
    """coscos2 of row-aligned embeddings (reference loss.py:59-67)."""
    return coscos2_from_cos(cosine_similarity(input1, input2), y,
                            weights=weights, avg=avg)


def cosmargin_fn(input1, input2, y, margin=0.5, weights=None, avg=True):
    """cosmargin of row-aligned embeddings (reference loss.py:97-105)."""
    return cosmargin_from_cos(cosine_similarity(input1, input2), y,
                              margin=margin, weights=weights, avg=avg)


def _hinge(x, y, margin):
    """HingeEmbeddingLoss: x where y == +1, max(0, margin - x) else."""
    return torch.where(y > 0, x, torch.clamp(margin - x, min=0.0))


def kl_loss_fn(input1, input2, y, margin=1.0, weights=None, avg=True,
               eps=1e-8):
    """Symmetric contrastive KL with a hinge on diff pairs (reference
    loss.py:127-137). Inputs must be positive distributions (e.g. softmax
    outputs).

    ``eps`` keeps log() finite on saturated softmax outputs and on
    all-zero padded rows (0*log(0/0) would poison the weighted sum with
    NaN even at weight 0, since 0*nan = nan)."""
    r = torch.log((input1 + eps) / (input2 + eps))
    kld1 = torch.sum(input1 * r, dim=1)
    kld2 = -torch.sum(input2 * r, dim=1)
    return (_reduce(_hinge(kld1, y, margin), weights, avg)
            + _reduce(_hinge(kld2, y, margin), weights, avg))


class LossBuilder:
    """Generic loss wrapper (reference loss.py:15-34)."""

    #: True when the loss is elementwise in the cosine similarity.
    supports_cos = False

    #: True when the loss decomposes into per-cell statistics computable
    #: for all (i, j) frame pairs at once via batched matmuls, so the
    #: matrix-mode train step can weight them by the DTW alignment mask
    #: (:func:`abnet3_torch.parallel.mesh.use_matrix_loss`). The hooks
    #: below define the contract.
    supports_cells = False

    def __init__(self, *args, **kwargs):
        pass

    def pair_cells(self, e1, e2):
        """(B, T1, E) x (B, T2, E) -> per-cell statistics shaped
        (*stat, B, T1, T2) (batched matmuls)."""
        raise NotImplementedError(
            "Loss has no cell decomposition:", self.__class__.__name__)

    def rowwise_cells(self, x1, x2):
        """(N, E) x (N, E) aligned rows -> statistics (*stat, N)."""
        raise NotImplementedError(
            "Loss has no cell decomposition:", self.__class__.__name__)

    def from_cells(self, cells, y, weights=None):
        """Reduce per-cell statistics under labels y and weights (same
        reduction semantics as __call__ on gathered rows)."""
        raise NotImplementedError(
            "Loss has no cell decomposition:", self.__class__.__name__)

    def masked_same_sum(self, e1, e2, A):
        """sum over (i, j) cells of A[i, j] * value(cell, y=+1) via
        matmuls: the per-cell statistics never materialise (the
        matrix-mode path of the DTW-aligned same-word group)."""
        raise NotImplementedError(
            "Loss has no cell decomposition:", self.__class__.__name__)

    def cell_values(self, cells, y):
        """Elementwise loss values (no reduction) from cell statistics
        under labels y."""
        raise NotImplementedError(
            "Loss has no cell decomposition:", self.__class__.__name__)

    def from_parts(self, same_sum, same_wsum, rest_cells, y_rest, w_rest):
        """Final reduction from a pre-summed same-group contribution plus
        elementwise rest terms (the diff diagonal): the same semantics as
        ``__call__`` over the union of all terms."""
        total = same_sum + torch.sum(self.cell_values(rest_cells, y_rest)
                                     * w_rest)
        if self.avg:
            denom = global_sum(same_wsum + torch.sum(w_rest))
            return total / torch.clamp(denom, min=1.0)
        return total

    def __call__(self, *args, **kwargs):
        raise NotImplementedError("Unimplemented __call__ for class:",
                                  self.__class__.__name__)

    def whoami(self):
        return {"params": {k: v for k, v in self.__dict__.items()
                           if not k.startswith("_")},
                "class_name": self.__class__.__name__}


class _CosCellsMixin:
    """Cell hooks of the cos-elementwise losses: the per-cell statistic is
    the cosine itself. The same-pair value is AFFINE in cos
    (``_same_affine``), so the mask-weighted same-group loss folds into
    matmuls, sum(A * value) = alpha * sum(A) + beta * <e1n, A @ e2n>, and
    the (B, T1, T2) cosine matrix never materialises."""

    supports_cos = True
    supports_cells = True

    #: (alpha, beta) with same-pair value = alpha + beta * cos
    _same_affine = (0.0, 0.0)

    def pair_cells(self, e1, e2):
        return _pair_cos_matrix(e1, e2)

    def rowwise_cells(self, x1, x2):
        return cosine_similarity(x1, x2)

    def from_cells(self, cells, y, weights=None):
        return self.from_cos(cells, y, weights=weights)

    def from_cos(self, c, y, weights=None):
        return _reduce(self.cell_values(c, y), weights, self.avg)

    def masked_same_sum(self, e1, e2, A):
        alpha, beta = self._same_affine
        e1n, e2n = normalize_rows(e1), normalize_rows(e2)
        masked_dot = torch.sum(e1n * torch.bmm(A, e2n))
        return alpha * torch.sum(A) + beta * masked_dot

    def __call__(self, input1, input2, y, weights=None):
        assert input1.shape == input2.shape, "Input not the same size"
        return self.from_cos(cosine_similarity(input1, input2), y,
                             weights=weights)


class coscos2(_CosCellsMixin, LossBuilder):
    """same -> (1 - cos) / 2 ; diff -> cos^2 (reference loss.py:59-67)."""

    _same_affine = (0.5, -0.5)

    def __init__(self, avg=True, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.avg = avg

    def cell_values(self, cells, y):
        return _coscos2_values(cells, y)


class cosmargin(_CosCellsMixin, LossBuilder):
    """same -> 1 - cos ; diff -> max(0, cos - margin)
    (reference loss.py:97-105)."""

    _same_affine = (1.0, -1.0)

    def __init__(self, avg=True, margin=0.5, *args, **kwargs):
        super().__init__(*args, **kwargs)
        assert 0 <= margin <= 1
        self.margin = margin
        self.avg = avg

    def cell_values(self, cells, y):
        return _cosmargin_values(cells, y, self.margin)


class KLLoss(LossBuilder):
    """Symmetric contrastive KL (reference loss.py:108-137). Cell
    decomposition: with distributions P (B, T1, E), Q (B, T2, E) and
    H(p) = sum_d p_d log(p_d + eps),

        kld1[i, j] = H(p_i) - P_i . log(Q_j + eps)   (one matmul)
        kld2[i, j] = H(q_j) - log(P_i + eps) . Q_j   (one matmul)

    so the KL-on-softmax recipe trains in matrix mode like the cosine
    losses. Its cells carry a leading stat axis of 2 (kld1, kld2)."""

    supports_cells = True

    def __init__(self, margin=1, avg=True, eps=1e-8, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.margin = margin
        self.avg = avg
        self.eps = eps

    def __call__(self, input1, input2, y, weights=None):
        return kl_loss_fn(input1, input2, y, margin=self.margin,
                          weights=weights, avg=self.avg, eps=self.eps)

    def _logs(self, e1, e2):
        """(log(e1 + eps), log(e2 + eps), H(e1), H(e2)) over the last
        axis."""
        l1 = torch.log(e1 + self.eps)
        l2 = torch.log(e2 + self.eps)
        return l1, l2, torch.sum(e1 * l1, dim=-1), torch.sum(e2 * l2, dim=-1)

    def pair_cells(self, e1, e2):
        l1, l2, h1, h2 = self._logs(e1, e2)
        x12 = torch.bmm(e1, l2.transpose(1, 2))
        x21 = torch.bmm(l1, e2.transpose(1, 2))
        return torch.stack([h1[:, :, None] - x12, h2[:, None, :] - x21])

    def rowwise_cells(self, x1, x2):
        l1 = torch.log(x1 + self.eps)
        l2 = torch.log(x2 + self.eps)
        kld1 = torch.sum(x1 * (l1 - l2), dim=-1)
        kld2 = -torch.sum(x2 * (l1 - l2), dim=-1)
        return torch.stack([kld1, kld2])

    def from_cells(self, cells, y, weights=None):
        return (_reduce(_hinge(cells[0], y, self.margin), weights, self.avg)
                + _reduce(_hinge(cells[1], y, self.margin), weights,
                          self.avg))

    def masked_same_sum(self, e1, e2, A):
        """Same-pair KL is linear in the cell statistics (the hinge only
        applies to diff pairs), so sum(A * (kld1 + kld2)) folds into two
        masked matmuls plus entropy dot products."""
        l1, l2, h1, h2 = self._logs(e1, e2)
        s1 = (torch.sum(A.sum(2) * h1)
              - torch.sum(e1 * torch.bmm(A, l2)))
        s2 = (torch.sum(A.sum(1) * h2)
              - torch.sum(l1 * torch.bmm(A, e2)))
        return s1 + s2

    def cell_values(self, cells, y):
        return (_hinge(cells[0], y, self.margin)
                + _hinge(cells[1], y, self.margin))


class weighted_loss_multi(LossBuilder):
    """weight * loss_spk + (1 - weight) * loss_phn for multitask training
    (reference loss.py:140-182)."""

    def __init__(self, avg=True, loss_phn=None, loss_spk=None, weight=0.5,
                 *args, **kwargs):
        super().__init__(*args, **kwargs)
        assert isinstance(weight, float)
        assert 0 <= weight <= 1
        self.weight = weight
        self.avg = avg
        self.loss_phn = loss_phn
        self.loss_spk = loss_spk

    def __call__(self, emb_spk1, emb_phn1, emb_spk2, emb_phn2, y_spk, y_phn,
                 weights=None):
        out_spk = self.loss_spk(emb_spk1, emb_spk2, y_spk, weights=weights)
        out_phn = self.loss_phn(emb_phn1, emb_phn2, y_phn, weights=weights)
        return self.weight * out_spk + (1.0 - self.weight) * out_phn

    @property
    def supports_multi_cells(self):
        """True when both sub-losses have a cell decomposition, so the
        multitask matrix-mode step can reduce per-head cell matrices under
        one alignment mask."""
        return (getattr(self.loss_spk, "supports_cells", False)
                and getattr(self.loss_phn, "supports_cells", False))

    def from_cells_multi(self, cells_spk, cells_phn, y_spk, y_phn,
                         weights=None):
        """The multitask loss on precomputed per-head cell statistics (the
        weighting of __call__)."""
        out_spk = self.loss_spk.from_cells(cells_spk, y_spk, weights=weights)
        out_phn = self.loss_phn.from_cells(cells_phn, y_phn, weights=weights)
        return self.weight * out_spk + (1.0 - self.weight) * out_phn

    def whoami(self):
        return {"params": {"weight": self.weight, "avg": self.avg,
                           "loss_phn": self.loss_phn.whoami(),
                           "loss_spk": self.loss_spk.whoami()},
                "class_name": self.__class__.__name__}
