"""Device-resident token bank: the whole training corpus lives on the card.

The counterpart of ``abnet3_tpu/ops/bank.py``'s ``TokenBank`` and
``upload_rows``. Every
unique token is copied once into one padded ``(N_tokens, T_max, d)``
float32 tensor, so a train step receives only token ids and gathers its
frames on the device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from abnet3_torch.profiling import span
from abnet3_torch.utils import resolve_device

__all__ = ["TokenBank", "upload_rows"]


def _bucket(n: int, minimum: int = 16) -> int:
    """Round up to a multiple of 16. A bank is built once per run, and the
    DTW DP cost is quadratic in the padded length."""
    return max(minimum, ((n + 15) // 16) * 16)


def upload_rows(arr: np.ndarray, device=None) -> torch.Tensor:
    """A host (N, ...) array as one float32 tensor on ``device`` (default:
    the card): the frame tables of the tcl mixing and of the frame
    loaders."""
    return torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(
        resolve_device(device))


class TokenBank:
    """Padded device tensor of token feature matrices + host key index.
    ``device`` defaults to the card (see
    :func:`abnet3_torch.utils.resolve_device`)."""

    def __init__(self, token_feats: Dict, max_frames: int = None,
                 device=None):
        """token_feats: {key: (T_i, d) float32 array}. The host padding
        and the upload are the span ``bank.build``."""
        with span("bank.build"):
            device = resolve_device(device)
            self.keys = list(token_feats.keys())
            self.key_to_id = {k: i for i, k in enumerate(self.keys)}
            lens = [len(token_feats[k]) for k in self.keys]
            T = _bucket(max(max(lens), 1))
            if max_frames is not None:
                T = min(T, _bucket(max_frames))
            d = next(iter(token_feats.values())).shape[1]
            bank = np.zeros((len(self.keys), T, d), np.float32)
            for i, k in enumerate(self.keys):
                f = token_feats[k]
                n = min(len(f), T)
                bank[i, :n] = f[:n]
            self.max_len = T
            self.dim = d
            self.bank = torch.from_numpy(bank).to(device)
            # host copy: bucketing reads lengths without a device sync
            self.lengths_host = np.minimum(np.asarray(lens, np.int32), T)
            self.lengths = torch.from_numpy(self.lengths_host).to(device)

    def __len__(self):
        return len(self.keys)

    def take(self, idx: torch.Tensor, max_frames: int = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """On-device gather: (B,) token ids -> ((B, T, d) frames, (B,)
        int32 lengths). ``max_frames`` cuts the time axis (length
        bucketing: short pairs run small DTW shapes)."""
        if max_frames is None or max_frames >= self.max_len:
            return self.bank[idx], self.lengths[idx]
        return (self.bank[idx, :max_frames],
                torch.clamp(self.lengths[idx], max=max_frames))

    def bucket_for(self, n: int) -> int:
        """Smallest value of the coarse ladder {16, 32, 64, ..., max_len}
        that covers n."""
        b = 16
        while b < n and b < self.max_len:
            b *= 2
        return min(b, self.max_len)
