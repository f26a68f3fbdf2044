"""Contrastive cosine losses and their cell decomposition.

The counterpart of ``abnet3_tpu/loss.py`` for ``coscos2`` and
``cosmargin``: the same math, with an optional per-example ``weights``
vector so padded frames of ragged device batches contribute zero loss,
and the cell hooks the matrix-mode train step
(:mod:`abnet3_torch.parallel.mesh`) reduces under the DTW path mask.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["cosine_similarity", "normalize_rows", "LossBuilder", "coscos2",
           "cosmargin"]


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
            return total / torch.clamp(torch.sum(weights), min=1.0)
        return total
    if avg:
        return torch.mean(values)
    return torch.sum(values)


class LossBuilder:
    """Generic loss wrapper (reference loss.py:15-34)."""

    #: True when the loss is elementwise in the cosine similarity.
    supports_cos = False

    #: True when the loss decomposes into per-cell statistics computable
    #: for all (i, j) frame pairs at once, so the matrix-mode train step
    #: can weight them by the DTW alignment mask.
    supports_cells = False

    def __init__(self, *args, **kwargs):
        pass

    def pair_cells(self, e1, e2):
        """(B, T1, E) x (B, T2, E) -> per-cell statistics (B, T1, T2)."""
        raise NotImplementedError(
            "Loss has no cell decomposition:", self.__class__.__name__)

    def rowwise_cells(self, x1, x2):
        """(N, E) x (N, E) aligned rows -> statistics (N,)."""
        raise NotImplementedError(
            "Loss has no cell decomposition:", self.__class__.__name__)

    def from_cells(self, cells, y, weights=None):
        """Reduce per-cell statistics under labels y and weights."""
        raise NotImplementedError(
            "Loss has no cell decomposition:", self.__class__.__name__)

    def masked_same_sum(self, e1, e2, A):
        """sum over (i, j) cells of A[i, j] * value(cell, y=+1)."""
        raise NotImplementedError(
            "Loss has no cell decomposition:", self.__class__.__name__)

    def cell_values(self, cells, y):
        """Elementwise loss values (no reduction) under labels y."""
        raise NotImplementedError(
            "Loss has no cell decomposition:", self.__class__.__name__)

    def from_parts(self, same_sum, same_wsum, rest_cells, y_rest, w_rest):
        """Final reduction from a pre-summed same-group contribution plus
        elementwise rest terms (the diff diagonal): the same semantics as
        ``__call__`` over the union of all terms."""
        total = same_sum + torch.sum(self.cell_values(rest_cells, y_rest)
                                     * w_rest)
        if self.avg:
            denom = same_wsum + torch.sum(w_rest)
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
        return torch.where(y > 0, (1.0 - cells) / 2.0, cells * cells)


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
        return torch.where(y > 0, 1.0 - cells,
                           torch.clamp(cells - self.margin, min=0.0))
