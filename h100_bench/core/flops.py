"""Model FLOPs of the work a cell needs, from the configuration's widths
and the true lengths of the tokens (padding and recomputation are not
counted): the towers on every frame of a pair once (forward, and with
training the backward at twice the forward), the angular-distance
matrix and the DTW recurrence of each same-word pair, the embedding
cosines of its path (bounded by n1 + n2 cells) and of a different-word
pair's diagonal."""

from __future__ import annotations

import numpy as np


class ModelFlops:
    def __init__(self, config):
        ref = config.reference
        self.tower = 2 * sum(a * b for a, b in
                             ref.shapes(config.values).values())
        self.heads = sum(ref.head_dims(config.values))
        self.dim = config.values["input_dim"]

    def pairs(self, n1, n2, same, train: bool) -> float:
        """FLOPs of a batch of pairs (arrays of lengths and same flags)."""
        n1, n2 = np.asarray(n1, np.float64), np.asarray(n2, np.float64)
        same = np.asarray(same, bool)
        k = 3.0 if train else 1.0
        cells = n1 * n2
        cos_terms = np.where(same, n1 + n2, np.minimum(n1, n2))
        return float(k * self.tower * (n1 + n2).sum()
                     + (2 * self.dim * cells + 3 * cells)[same].sum()
                     + k * 2 * self.heads * cos_terms.sum())

    def export(self, n_frames: int) -> float:
        return float(self.tower * n_frames)
