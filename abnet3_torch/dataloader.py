"""Dataloader of the training slices: token-pair files + features ->
batches for the train step.

The counterpart of ``abnet3_tpu/dataloader.py``'s ``OriginalDataLoader``
on two backends:

- ``device`` (the default, as in the JAX package): each batch of pairs
  is padded into power-of-two length buckets, the same pairs are aligned
  on the device (angular distances, the DTW move kernel, the backtrace
  walk) and the aligned frames are gathered into a :class:`Batch` of
  frame pairs with per-frame weights;
- ``bank`` with the static same/diff split (``bank_split=True``), the
  flagship recipe: batches hold token ids and per-pair weights only, and
  the step gathers the frames from a device-resident token bank.

The loader draws from ``np.random.RandomState(seed)`` in the same order as
the JAX loader (batch selection each pass, the shuffles), so the two
packages see the same batches.
"""

from __future__ import annotations

import inspect
import os
from collections import defaultdict
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from abnet3_torch.utils import (Features_Accessor, group_pairs,
                                pow2_bucket, read_dataset, read_feats,
                                resolve_device)

__all__ = ["Batch", "SplitBankBatch", "DataLoader", "OriginalDataLoader"]


class Batch(NamedTuple):
    """One batch of aligned frame pairs (device backend): x1, x2 (N, d),
    y (N,) +1 same / -1 different, weights (N,) 1 on path frames and 0 on
    the padding past each pair's path."""
    x1: torch.Tensor
    x2: torch.Tensor
    y: torch.Tensor
    weights: torch.Tensor


class SplitBankBatch(NamedTuple):
    """Bank index batch with a STATIC same/diff split: the step runs the
    DTW DP only on the same-word group and the cheap truncate/diagonal
    alignment on the diff group. Group sizes are fixed per dataloader
    (ragged tails carry weight 0)."""
    ids1s: np.ndarray
    ids2s: np.ndarray
    ws: np.ndarray     # (Bs,) same-pair validity weights
    ids1d: np.ndarray
    ids2d: np.ndarray
    wd: np.ndarray     # (Bd,) diff-pair validity weights
    bucket: int = None


class DataLoader:
    """Base interface (reference dataloader.py:29-40)."""

    def batch_iterator(self, train_mode=True):
        raise NotImplementedError(
            "You must implement batch_iterator in DataLoader class.")

    def whoami(self):
        """Reproducibility dump: every non-private constructor argument
        across the MRO, read back from the instance (reference
        dataloader.py:60-84)."""
        params = {}
        for cls in type(self).__mro__:
            init = cls.__dict__.get("__init__")
            if init is None:
                continue
            for name, p in inspect.signature(init).parameters.items():
                if name == "self" or p.kind in (p.VAR_POSITIONAL,
                                                p.VAR_KEYWORD):
                    continue
                params.setdefault(name, getattr(self, name))
        return {"params": params, "class_name": self.__class__.__name__}


def _pad_tokens(feats: Sequence[np.ndarray], T: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-pad token feature matrices into (n, T, d), with their
    lengths."""
    d = feats[0].shape[1]
    out = np.zeros((len(feats), T, d), np.float32)
    lens = np.zeros((len(feats),), np.int32)
    for i, f in enumerate(feats):
        n = min(len(f), T)
        out[i, :n] = f[:n]
        lens[i] = n
    return out, lens


class OriginalDataLoader(DataLoader):
    """Pair files -> DTW-aligned frame-pair batches (``device`` backend)
    or same/diff split index batches against a token bank (``bank``)
    (reference dataloader.py:43-352).

    The ``host`` backend, ``tcl > 0`` and, on the bank backend,
    ``bank_split=False`` are not ported and raise ``NotImplementedError``.
    ``device`` places the batches and the token bank (default: the card,
    see :func:`abnet3_torch.utils.resolve_device`). ``steps_per_call`` is
    read by the trainer, which buffers bank batches per length bucket to
    that depth as the JAX trainer does.
    """

    def __init__(self, pairs_path, features_path, num_max_minibatches=1000,
                 seed=None, batch_size=8, shuffle_between_epochs=False,
                 align_different_words=False, tcl=0.0,
                 align_backend="device", bank_split=True, steps_per_call=8,
                 device=None):
        if align_backend not in ("device", "bank"):
            raise NotImplementedError(
                f"align_backend={align_backend!r}: abnet3_torch ports the "
                "'device' and 'bank' backends only")
        if align_backend == "bank" and not bank_split:
            raise NotImplementedError(
                "bank_split=False (mixed same/diff bank batches) is not "
                "ported")
        if tcl:
            raise NotImplementedError(
                "tcl > 0 (temporal-coherence pairs) is not ported")
        assert steps_per_call >= 1, "steps_per_call must be >= 1"
        self.pairs_path = pairs_path
        self.features_path = features_path
        self.statistics_training = defaultdict(int)
        self.seed = seed
        self.num_max_minibatches = num_max_minibatches
        self.batch_size = batch_size
        self.features: Optional[Features_Accessor] = None
        self.shuffle_between_epochs = shuffle_between_epochs
        self.align_different_words = align_different_words
        self.tcl = tcl
        self.align_backend = align_backend
        self.bank_split = bank_split
        self.steps_per_call = steps_per_call
        self.device = device
        self.train_files = None
        self.pairs = {"train": None, "dev": None}
        self.token_bank = None
        self._bank_pairs = None
        self._rng = np.random.RandomState(seed)

    # -- data ------------------------------------------------------------

    def load_data(self):
        """Load features + pair lists once (reference
        dataloader.py:125-145); a caller may set ``features`` or
        ``pairs`` beforehand instead."""
        if self.features is None:
            print("Loading features")
            features, _, _ = read_feats(self.features_path)
            self.features = features
        if self.pairs["train"] is None:
            print("Loading word pairs")
            self.pairs["train"] = read_dataset(
                os.path.join(self.pairs_path, "train_pairs/dataset"))
        if self.pairs["dev"] is None:
            self.pairs["dev"] = read_dataset(
                os.path.join(self.pairs_path, "dev_pairs/dataset"))
        self.train_files = sorted(
            {p[0] for p in self.pairs["train"]}
            | {p[3] for p in self.pairs["train"]})
        if self.align_backend == "bank" and self.token_bank is None:
            self._build_token_bank()

    def _build_token_bank(self):
        """Copy every unique token of both splits into one device-resident
        TokenBank and precompute per-split (id1, id2, y, bucket) arrays,
        length-sorted so batches hold similar-length pairs."""
        from abnet3_torch.ops.bank import TokenBank
        all_pairs = {m: group_pairs(self.pairs[m]) for m in
                     ("train", "dev")}
        token_feats = {}
        for m in ("train", "dev"):
            token_feats.update(self.get_token_feats(all_pairs[m]))
        # drop zero-length tokens (degenerate slices the reference skips)
        token_feats = {k: v for k, v in token_feats.items() if len(v) > 0}
        print("Uploading %d tokens to the device token bank"
              % len(token_feats))
        self.token_bank = TokenBank(token_feats, device=self.device)
        self._bank_pairs = {}
        key_to_id = self.token_bank.key_to_id
        for m in ("train", "dev"):
            ids1, ids2, ys = [], [], []
            for f1, s1, e1, f2, s2, e2, ptype in self.pairs[m]:
                k1, k2 = (f1, s1, e1), (f2, s2, e2)
                if k1 not in key_to_id or k2 not in key_to_id:
                    continue
                ids1.append(key_to_id[k1])
                ids2.append(key_to_id[k2])
                ys.append(1.0 if ptype == "same" else -1.0)
            ids1 = np.asarray(ids1, np.int32)
            ids2 = np.asarray(ids2, np.int32)
            ys = np.asarray(ys, np.float32)
            lens = self.token_bank.lengths_host
            pair_len = np.maximum(lens[ids1], lens[ids2])
            order = np.argsort(pair_len, kind="stable")
            # the coarse power-of-two ladder; max_len joins the probes so
            # tokens past the last power of two still find a rung
            ladder = np.asarray(sorted({self.token_bank.bucket_for(b)
                                        for b in (1, 16, 32, 64, 128,
                                                  256, 512, 1024, 2048,
                                                  4096,
                                                  self.token_bank.max_len)}))
            buckets = ladder[np.searchsorted(ladder, pair_len[order])]
            self._bank_pairs[m] = (ids1[order], ids2[order], ys[order],
                                   buckets)

    def _epoch_bank_pairs(self, mode):
        """Pairs for one epoch: length-sorted, and (with
        shuffle_between_epochs) re-shuffled within equal-bucket groups."""
        ids1, ids2, ys, buckets = self._bank_pairs[mode]
        if not self.shuffle_between_epochs or len(ids1) == 0:
            return ids1, ids2, ys
        order = np.arange(len(ids1))
        for b in np.unique(buckets):
            grp = np.flatnonzero(buckets == b)
            order[grp] = self._rng.permutation(order[grp])
        return ids1[order], ids2[order], ys[order]

    def batch_iterator(self, train_mode=True):
        """Yield one pass of batches (an 'epoch' samples
        num_max_minibatches batches, reference dataloader.py:263-312):
        :class:`Batch` on the device backend, :class:`SplitBankBatch` on
        the bank backend."""
        self.load_data()
        mode = "train" if train_mode else "dev"
        if self.align_backend == "bank":
            ids1, ids2, ys = self._epoch_bank_pairs(mode)
            if len(ids1) == 0:  # empty split: no batches
                return
            yield from self._split_bank_batches(ids1, ids2, ys,
                                                count_stats=train_mode)
            return
        batches, selected = self._select_batches(list(self.pairs[mode]))
        for batch_id in selected:
            batch = self.load_frames_from_pairs_device(
                group_pairs(batches[batch_id]))
            if batch is not None:
                yield batch

    def _select_batches(self, pairs):
        """Cut the pair list into batch_size slices (after a shuffle when
        shuffle_between_epochs) and pick num_max_minibatches of them."""
        num_pairs = len(pairs)
        if self.shuffle_between_epochs:
            self._rng.shuffle(pairs)
        sliced = range(0, num_pairs, self.batch_size)
        batches = [pairs[i:i + self.batch_size] for i in sliced]
        if self.num_max_minibatches < len(batches):
            selected = self._rng.choice(len(batches),
                                        self.num_max_minibatches,
                                        replace=False)
        else:
            print("Number of batches not sufficient,"
                  " iterating over all the batches")
            selected = self._rng.permutation(len(batches))
        return batches, selected

    # -- device batch construction ----------------------------------------

    def _collect_pair_feats(self, pairs, token_feats, group):
        """Valid (feat1, feat2) pairs of one group; drops the degenerate
        tokens the reference skips (reference dataloader.py:184-190)."""
        out = []
        for f1, s1, e1, f2, s2, e2 in pairs[group]:
            if (s1 > e1) or (s2 > e2):
                continue
            feat1 = token_feats[f1, s1, e1]
            feat2 = token_feats[f2, s2, e2]
            if len(feat1) == 0 or len(feat2) == 0:
                continue
            out.append((feat1, feat2))
        return out

    def load_frames_from_pairs_device(self, pairs):
        """Device-aligned batch of grouped pairs ({'same': [...], 'diff':
        [...]}), or None when no pair is valid (reference
        dataloader.py:166-261)."""
        return self._assemble_device(pairs, self.get_token_feats(pairs))

    def _assemble_device(self, pairs, token_feats):
        """Pad each group into power-of-two length buckets, align it on
        the device (DTW for same pairs, truncate/diagonal for different
        ones), gather the aligned frames and flatten both groups into one
        :class:`Batch`; frames past a pair's path weigh 0. Counts the
        pairs of every pass in ``statistics_training``, as the JAX loader
        does."""
        from abnet3_torch.ops.dtw import aligned_frame_pairs
        dev = resolve_device(self.device)
        segs = []
        for group in ("same", "diff"):
            feats = self._collect_pair_feats(pairs, token_feats, group)
            if not feats:
                continue
            is_same = group == "same"
            T1 = pow2_bucket(max(len(a) for a, _ in feats))
            T2 = pow2_bucket(max(len(b) for _, b in feats))
            f1, n1 = (torch.from_numpy(a).to(dev) for a in
                      _pad_tokens([a for a, _ in feats], T1))
            f2, n2 = (torch.from_numpy(a).to(dev) for a in
                      _pad_tokens([b for _, b in feats], T2))
            segs.append(aligned_frame_pairs(
                f1, f2, n1, n2, is_same,
                align_different_words=self.align_different_words))
            self.statistics_training[
                "SameType" if is_same else "DiffType"] += len(feats)
        if not segs:
            return None
        return Batch(*(torch.cat(parts) for parts in zip(*segs)))

    def get_token_feats(self, pairs):
        """Slice unique token features (reference dataloader.py:147-164)."""
        token_feats = {}
        for group in ("same", "diff"):
            for f1, s1, e1, f2, s2, e2 in pairs[group]:
                if (f1, s1, e1) not in token_feats:
                    token_feats[f1, s1, e1] = self.features.get(f1, s1, e1)
                if (f2, s2, e2) not in token_feats:
                    token_feats[f2, s2, e2] = self.features.get(f2, s2, e2)
        return token_feats

    def _split_bank_batches(self, ids1, ids2, ys, count_stats=True):
        """Yield SplitBankBatch index batches with static per-group sizes:
        Bs same + Bd diff pairs per batch (proportional to the split's
        global same/diff ratio; ragged tails weigh 0)."""
        same = ys > 0
        s1, s2 = ids1[same], ids2[same]
        d1, d2 = ids1[~same], ids2[~same]
        n_s, n_d = len(s1), len(d1)
        bs = self.batch_size
        Bs = max(1, round(bs * n_s / max(n_s + n_d, 1))) if n_s else 1
        Bd = max(bs - Bs, 1) if n_d else 1
        num_batches = max(
            (n_s + Bs - 1) // Bs if n_s else 0,
            (n_d + Bd - 1) // Bd if n_d else 0, 1)
        if self.num_max_minibatches < num_batches:
            selected = self._rng.choice(num_batches,
                                        self.num_max_minibatches,
                                        replace=False)
        else:
            selected = self._rng.permutation(num_batches)
        lens = self.token_bank.lengths_host

        def take(arr, b, B):
            sl = arr[b * B:(b + 1) * B]
            w = np.ones(B, np.float32)
            if len(sl) < B:
                w[len(sl):] = 0.0
                sl = np.concatenate([sl, np.zeros(B - len(sl), arr.dtype)])
            return sl, w

        for b in selected:
            bi1s, ws = take(s1, b, Bs)
            bi2s, _ = take(s2, b, Bs)
            bi1d, wd = take(d1, b, Bd)
            bi2d, _ = take(d2, b, Bd)
            if not n_s:
                ws[:] = 0.0
            if not n_d:
                wd[:] = 0.0
            maxlen = 1
            if ws.any():
                maxlen = max(maxlen, int(np.maximum(
                    lens[bi1s], lens[bi2s])[ws > 0].max()))
            if wd.any():
                maxlen = max(maxlen, int(np.maximum(
                    lens[bi1d], lens[bi2d])[wd > 0].max()))
            bucket = self.token_bank.bucket_for(maxlen)
            if count_stats:  # train pairs only (dev passes don't count)
                self.statistics_training["SameType"] += int(ws.sum())
                self.statistics_training["DiffType"] += int(wd.sum())
            yield SplitBankBatch(bi1s, bi2s, ws, bi1d, bi2d, wd,
                                 bucket=bucket)
