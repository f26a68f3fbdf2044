"""Dataloaders: token-pair files + features -> batches for the train step.

The counterpart of ``abnet3_tpu/dataloader.py``'s pair-file loaders.
``OriginalDataLoader`` runs on three backends:

- ``device`` (the default, as in the JAX package): each batch of pairs
  is padded into power-of-two length buckets, the same pairs are aligned
  on the device (angular distances, the DTW move kernel, the backtrace
  walk) and the aligned frames are gathered into a :class:`Batch` of
  frame pairs with per-frame weights;
- ``bank``: batches hold token ids and per-pair weights only, and the
  step gathers the frames from a device-resident token bank. With
  ``bank_split=True`` (the flagship recipe) a batch is a
  :class:`SplitBankBatch` of static same and diff groups; with
  ``bank_split=False`` a :class:`BankBatch` of mixed pairs;
- ``host``: the reference's numpy path (host DTW per same pair, frames
  stacked and shuffled on the host), whose frames then go to the device.

``tcl > 0`` mixes temporal-coherence frame pairs into every batch: on
the bank backend as index groups into a device frame table
(``frame_bank``), on the other two as frames drawn on the host.

``MultiTaskDataLoader`` adds the +1/-1 same/different-speaker label of
every pair (``y_spk`` fields, from a file-to-speaker map) on every
backend, for the multitask network. ``PairsDataLoader`` (numeric-frame
KNN pair files),
``TemporalCoherenceDataLoader`` (temporal-coherence pairs only, word
pairs for the dev pass) and ``FramesDataLoader`` (every pair aligned
once, frame-index batches against a device frame table,
:class:`FrameBankBatch`) build on it; ``MultimodalDataLoader`` is a
``FramesDataLoader`` over several feature sets, aligned on the first,
with one frame table per modality. ``OnDeviceSamplerDataLoader``
reads no pair file: it holds a token bank and the sampler's
distributions on the device per split, and the trainer's sampled steps
draw their pairs there.

The loaders draw from ``np.random.RandomState(seed)`` (``self._rng``) and
from the global ``random`` module exactly as the JAX loaders do, draw for
draw, so the two packages see the same batches. Every loader places its
tensors on ``device`` (default: the card, see
:func:`abnet3_torch.utils.resolve_device`).
"""

from __future__ import annotations

import inspect
import os
import queue as queue_mod
import random
import threading
from collections import defaultdict
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from abnet3_torch.profiling import count, span
from abnet3_torch.utils import (Features_Accessor, get_dtw_alignment,
                                group_pairs, pow2_bucket, read_dataset,
                                read_feats, read_spkid_file, resolve_device)

__all__ = ["Batch", "BankBatch", "SplitBankBatch", "FrameBankBatch",
           "DataLoader", "OriginalDataLoader", "PairsDataLoader",
           "TemporalCoherenceDataLoader", "FramesDataLoader",
           "MultiTaskDataLoader", "MultimodalDataLoader",
           "OnDeviceSamplerDataLoader", "prefetch_iterator"]

# spans and counters (abnet3_torch.profiling), by the split a pass reads:
# one batch's build; the alignment, walk and gathers of its device
# alignment; the bytes its pageable host-to-device copies move
_BUILD = {True: "train/loader.build", False: "dev/loader.build"}
_ALIGN = {True: ("train/loader.align", "train/loader.walk",
                 "train/loader.gather"),
          False: ("dev/loader.align", "dev/loader.walk", "dev/loader.gather")}
_H2D = {True: "train/h2d_pageable_bytes", False: "dev/h2d_pageable_bytes"}


class Batch(NamedTuple):
    """One batch of aligned frame pairs: x1, x2 (N, d), y (N,) +1 same /
    -1 different, weights (N,): 1 on path frames and 0 on the padding past
    each pair's path (device backend), all 1 on the host backend; y_spk
    (N,) +1 same / -1 different speaker, set by the multitask loader
    only."""
    x1: torch.Tensor
    x2: torch.Tensor
    y: torch.Tensor
    weights: torch.Tensor
    y_spk: torch.Tensor = None


class BankBatch(NamedTuple):
    """An index batch of mixed same/diff pairs against the token bank
    (``bank_split=False``): token ids, per-pair labels and weights
    (padded pairs: id 0, label +1, weight 0), the speaker labels of the
    multitask loader (padded pairs +1), the length bucket, and the
    optional temporal-coherence group (as in :class:`SplitBankBatch`)."""
    ids1: np.ndarray
    ids2: np.ndarray
    y: np.ndarray
    pair_w: np.ndarray
    y_spk: np.ndarray = None
    bucket: int = None
    tcl_i1: np.ndarray = None
    tcl_i2: np.ndarray = None
    tcl_y: np.ndarray = None
    tcl_w: np.ndarray = None


class SplitBankBatch(NamedTuple):
    """Bank index batch with a STATIC same/diff split: the step runs the
    DTW DP only on the same-word group and the cheap truncate/diagonal
    alignment on the diff group. Group sizes are fixed per dataloader
    (ragged tails carry weight 0). With tcl > 0 the batch carries a
    temporal-coherence group: frame-index pairs into the loader's
    ``frame_bank`` with their labels and weights; the step rescales the
    weights so that the group carries exactly tcl/(1-tcl) of the token
    pairs' total weight. The multitask loader sets each group's speaker
    labels (ragged tails +1)."""
    ids1s: np.ndarray
    ids2s: np.ndarray
    ws: np.ndarray     # (Bs,) same-pair validity weights
    ids1d: np.ndarray
    ids2d: np.ndarray
    wd: np.ndarray     # (Bd,) diff-pair validity weights
    y_spk_s: np.ndarray = None
    y_spk_d: np.ndarray = None
    bucket: int = None
    tcl_i1: np.ndarray = None
    tcl_i2: np.ndarray = None
    tcl_y: np.ndarray = None
    tcl_w: np.ndarray = None


class FrameBankBatch(NamedTuple):
    """Index-only frame batch against the loader's device frame table
    (``frame_tables``): the step gathers X1 = table[i1], X2 = table[i2].
    ``mode`` selects the train or dev table; padded rows weigh 0."""
    i1: np.ndarray
    i2: np.ndarray
    y: np.ndarray
    weights: np.ndarray = None
    mode: str = "train"


def prefetch_iterator(iterator, size: int = 2):
    """Run ``iterator`` in a background thread, keeping ``size`` items
    ready.

    The worker's puts poll a stop flag, so a consumer that stops early
    (a step raising mid-epoch closes this generator) unblocks the thread
    instead of leaving it parked on a full queue; an error of the source
    is raised in the consumer."""
    q: queue_mod.Queue = queue_mod.Queue(maxsize=size)
    sentinel = object()
    err: List[BaseException] = []
    stop = threading.Event()

    def q_put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue_mod.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not q_put(item):
                    return
        except BaseException as e:  # propagate into the consumer
            err.append(e)
        finally:
            q_put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        t.join(timeout=5)


class DataLoader:
    """Base interface (reference dataloader.py:29-40)."""

    #: constructor-arg name -> callable(self) for the args whose values
    #: are not stored under the same attribute name
    _WHOAMI_ALIASES: dict = {}

    def batch_iterator(self, train_mode=True):
        raise NotImplementedError(
            "You must implement batch_iterator in DataLoader class.")

    # pickle support, as the JAX package's (reference dataloader.py:86-117):
    # the state keeps the options, the pair lists and the host RNG, and
    # drops everything load_data() rebuilds (the features, the device
    # banks and tables, the samplers), so no tensor rides in a pickle;
    # __setstate__ rebuilds them on the loader's device. Features given
    # in memory (no features_path to reload them from) stay in the state.
    _HEAVY_ATTRS = ("token_bank", "_bank_pairs", "frame_bank",
                    "device_samplers", "_banks")
    _HEAVY_MODE_DICTS = ("token_features", "frame_pairs", "_tables_dev")

    def __getstate__(self):
        d = dict(self.__dict__)
        if d.get("features_path") is not None and "features" in d:
            d["features"] = None
        for k in self._HEAVY_ATTRS:
            if k in d:
                d[k] = None
        for k in self._HEAVY_MODE_DICTS:
            if k in d:
                d[k] = {mode: None for mode in d[k]}
        d["statistics_training"] = dict(self.statistics_training)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.statistics_training = defaultdict(
            int, d.get("statistics_training", {}))
        self.load_data()

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
                if name in params:
                    continue  # nearest-subclass value wins
                alias = self._WHOAMI_ALIASES.get(name)
                params[name] = (alias(self) if alias is not None
                                else getattr(self, name))
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


def _take(arr: Optional[np.ndarray], index):
    """``arr[index]``, or None for a missing label stream."""
    return None if arr is None else arr[index]


class OriginalDataLoader(DataLoader):
    """Pair files -> DTW-aligned frame-pair batches (``device`` and
    ``host`` backends) or index batches against a token bank (``bank``)
    (reference dataloader.py:43-352).

    ``device`` places the batches, the token bank and the tcl frame bank
    (default: the card). ``steps_per_call`` is read by the trainer, which
    buffers index batches per length bucket to that depth as the JAX
    trainer does.
    """

    TCL_DISTANCE_SAME = [1]
    TCL_DISTANCES_DIFF = [15, 20, 25, 30]

    def __init__(self, pairs_path, features_path, num_max_minibatches=1000,
                 seed=None, batch_size=8, shuffle_between_epochs=False,
                 align_different_words=False, tcl=0.0,
                 align_backend="device", bank_split=True, steps_per_call=8,
                 device=None):
        if not 0 <= tcl < 1:
            raise ValueError(f"tcl must be in [0, 1), got {tcl}")
        if align_backend not in ("device", "bank", "host"):
            raise ValueError(f"align_backend must be 'device', 'bank' or "
                             f"'host', got {align_backend!r}")
        if steps_per_call < 1:
            raise ValueError("steps_per_call must be >= 1")
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
        self.frame_bank = None  # (N_frames, d) device frame table (tcl)
        self._tcl_files = None
        self._tcl_anchors = None
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
        # sorted: the frame bank's layout and the tcl file draws index
        # into this list
        self.train_files = sorted(
            {p[0] for p in self.pairs["train"]}
            | {p[3] for p in self.pairs["train"]})
        if self.align_backend == "bank" and self.token_bank is None:
            self._build_token_bank()
        if (self.align_backend == "bank" and self.tcl > 0
                and self.frame_bank is None):
            self._build_frame_bank()

    def _build_token_bank(self, fid2spk=None):
        """Copy every unique token of both splits into one device-resident
        TokenBank and precompute per-split (id1, id2, y, y_spk, bucket)
        arrays, length-sorted so batches hold similar-length pairs;
        ``y_spk`` (+1 same / -1 different speaker, from ``fid2spk``) is
        None without a speaker map."""
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
            ids1, ids2, ys, yspk = [], [], [], []
            for f1, s1, e1, f2, s2, e2, ptype in self.pairs[m]:
                k1, k2 = (f1, s1, e1), (f2, s2, e2)
                if k1 not in key_to_id or k2 not in key_to_id:
                    continue
                ids1.append(key_to_id[k1])
                ids2.append(key_to_id[k2])
                ys.append(1.0 if ptype == "same" else -1.0)
                if fid2spk is not None:
                    yspk.append(1.0 if fid2spk[f1] == fid2spk[f2] else -1.0)
            ids1 = np.asarray(ids1, np.int32)
            ids2 = np.asarray(ids2, np.int32)
            ys = np.asarray(ys, np.float32)
            yspk = (np.asarray(yspk, np.float32) if fid2spk is not None
                    else None)
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
                                   _take(yspk, order), buckets)

    def _epoch_bank_pairs(self, mode):
        """Pairs for one epoch, (ids1, ids2, ys, yspk): length-sorted, and
        (with shuffle_between_epochs) re-shuffled within equal-bucket
        groups."""
        ids1, ids2, ys, yspk, buckets = self._bank_pairs[mode]
        if not self.shuffle_between_epochs or len(ids1) == 0:
            return ids1, ids2, ys, yspk
        order = np.arange(len(ids1))
        for b in np.unique(buckets):
            grp = np.flatnonzero(buckets == b)
            order[grp] = self._rng.permutation(order[grp])
        return ids1[order], ids2[order], ys[order], _take(yspk, order)

    def get_token_feats(self, pairs, frames=False):
        """Slice unique token features (reference dataloader.py:147-164);
        ``frames=True`` reads the bounds as frame indices."""
        token_feats = {}
        get_features = (self.features.get_between_frames if frames
                        else self.features.get)
        for group in ("same", "diff"):
            for f1, s1, e1, f2, s2, e2 in pairs[group]:
                if (f1, s1, e1) not in token_feats:
                    token_feats[f1, s1, e1] = get_features(f1, s1, e1)
                if (f2, s2, e2) not in token_feats:
                    token_feats[f2, s2, e2] = get_features(f2, s2, e2)
        return token_feats

    # -- iteration ----------------------------------------------------------

    def batch_iterator(self, train_mode=True):
        """Yield one pass of batches (an 'epoch' samples
        num_max_minibatches batches, reference dataloader.py:263-312):
        :class:`Batch` on the device and host backends, index batches on
        the bank backend."""
        self.load_data()
        if self.align_backend == "bank":
            yield from self.bank_batch_iterator(train_mode)
            return
        mode = "train" if train_mode else "dev"
        batches, selected = self._select_batches(list(self.pairs[mode]))
        n = 0
        for batch_id in selected:
            with span(_BUILD[train_mode], n):
                grouped = group_pairs(batches[batch_id])
                if self.align_backend == "device":
                    batch = self.load_frames_from_pairs_device(
                        grouped, train_mode=train_mode)
                    if batch is not None and self.tcl > 0:
                        batch = self._add_tcl(batch, train_mode)
                else:
                    X1, X2, y = self.load_frames_from_pairs(grouped)
                    if self.tcl > 0:
                        X1, X2, y = self.add_tcl_to_batch((X1, X2, y))
                    batch = self._host_batch(X1, X2, y,
                                             train_mode=train_mode)
            if batch is None:
                continue
            n += 1
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

    def bank_batch_iterator(self, train_mode=True):
        """Yield fixed-size index batches against the token bank:
        :class:`SplitBankBatch` (``bank_split``) or :class:`BankBatch`."""
        self.load_data()
        mode = "train" if train_mode else "dev"
        ids1, ids2, ys, yspk = self._epoch_bank_pairs(mode)
        num_pairs = len(ids1)
        if num_pairs == 0:  # empty split: no batches
            return
        if self.bank_split:
            yield from self._split_bank_batches(ids1, ids2, ys, yspk,
                                                train_mode=train_mode)
            return
        bs = self.batch_size
        num_batches = (num_pairs + bs - 1) // bs
        if self.num_max_minibatches < num_batches:
            selected = self._rng.choice(num_batches,
                                        self.num_max_minibatches,
                                        replace=False)
        else:
            selected = self._rng.permutation(num_batches)
        lens = self.token_bank.lengths_host
        for k, b in enumerate(selected):
            with span(_BUILD[train_mode], k):
                sl = slice(b * bs, (b + 1) * bs)
                bi1, bi2, by = ids1[sl], ids2[sl], ys[sl]
                bspk = _take(yspk, sl)
                n = len(bi1)
                bucket = self.token_bank.bucket_for(
                    int(np.maximum(lens[bi1], lens[bi2]).max()))
                w = np.ones(bs, np.float32)
                if n < bs:  # pad the ragged tail; padded pairs weigh 0
                    pad = bs - n
                    bi1 = np.concatenate([bi1, np.zeros(pad, np.int32)])
                    bi2 = np.concatenate([bi2, np.zeros(pad, np.int32)])
                    by = np.concatenate([by, np.ones(pad, np.float32)])
                    if bspk is not None:
                        bspk = np.concatenate([bspk,
                                               np.ones(pad, np.float32)])
                    w[n:] = 0.0
                if train_mode:
                    self.statistics_training["SameType"] += int(
                        ((by > 0) & (w > 0)).sum())
                    self.statistics_training["DiffType"] += int(
                        ((by < 0) & (w > 0)).sum())
                batch = BankBatch(bi1.astype(np.int32), bi2.astype(np.int32),
                                  by, w, bspk, bucket=bucket,
                                  **self._tcl_fields())
            yield batch

    def _tcl_fields(self):
        """The batch's temporal-coherence group as BankBatch /
        SplitBankBatch fields: drawn when tcl > 0 and the frame bank
        exists (TemporalCoherenceDataLoader holds a frame bank with tcl
        == 0, and its dev pass comes through here)."""
        if self.tcl > 0 and self.frame_bank is not None:
            ti1, ti2, ty, tw = self._sample_tcl_group()
            return dict(tcl_i1=ti1, tcl_i2=ti2, tcl_y=ty, tcl_w=tw)
        return {}

    def _split_bank_batches(self, ids1, ids2, ys, yspk=None,
                            train_mode=True):
        """Yield SplitBankBatch index batches with static per-group sizes:
        Bs same + Bd diff pairs per batch (proportional to the split's
        global same/diff ratio; ragged tails weigh 0, their speaker labels
        +1). A train pass (``train_mode``) counts its pairs in
        ``statistics_training``."""
        same = ys > 0
        s1, s2 = ids1[same], ids2[same]
        d1, d2 = ids1[~same], ids2[~same]
        spk_s, spk_d = _take(yspk, same), _take(yspk, ~same)
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

        def take(arr, b, B, fill=0):
            sl = arr[b * B:(b + 1) * B]
            w = np.ones(B, np.float32)
            if len(sl) < B:
                w[len(sl):] = 0.0
                sl = np.concatenate([sl, np.full(B - len(sl), fill,
                                                 arr.dtype)])
            return sl, w

        for k, b in enumerate(selected):
            with span(_BUILD[train_mode], k):
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
                bspk_s = bspk_d = None
                if yspk is not None:
                    bspk_s, _ = take(spk_s, b, Bs, fill=1.0)
                    bspk_d, _ = take(spk_d, b, Bd, fill=1.0)
                if train_mode:  # train pairs only (dev passes don't count)
                    self.statistics_training["SameType"] += int(ws.sum())
                    self.statistics_training["DiffType"] += int(wd.sum())
                batch = SplitBankBatch(bi1s, bi2s, ws, bi1d, bi2d, wd,
                                       bspk_s, bspk_d, bucket=bucket,
                                       **self._tcl_fields())
            yield batch

    # -- device batch construction ----------------------------------------

    def _collect_pair_feats(self, pairs, token_feats, group):
        """Valid pairs of one group as ((feat1, feat2), pair), pair the
        6-tuple of the pair file; drops the degenerate tokens the
        reference skips (reference dataloader.py:184-190)."""
        out = []
        for pair in pairs[group]:
            f1, s1, e1, f2, s2, e2 = pair
            if (s1 > e1) or (s2 > e2):
                continue
            feat1 = token_feats[f1, s1, e1]
            feat2 = token_feats[f2, s2, e2]
            if len(feat1) == 0 or len(feat2) == 0:
                continue
            out.append(((feat1, feat2), pair))
        return out

    def load_frames_from_pairs_device(self, pairs, fid2spk=None,
                                      train_mode=True):
        """Device-aligned batch of grouped pairs ({'same': [...], 'diff':
        [...]}), or None when no pair is valid (reference
        dataloader.py:166-261); with ``fid2spk`` it carries the speaker
        labels. ``train_mode``: the split whose pass the batch is for
        (it names the batch's spans and counters)."""
        return self._assemble_device(pairs, self.get_token_feats(pairs),
                                     fid2spk, train_mode)

    def _assemble_device(self, pairs, token_feats, fid2spk=None,
                         train_mode=True):
        """Pad each group into power-of-two length buckets, align it on
        the device (DTW for same pairs, truncate/diagonal for different
        ones), gather the aligned frames and flatten both groups into one
        :class:`Batch`; frames past a pair's path weigh 0. With a
        file-to-speaker map each frame pair gets its pair's +1/-1 speaker
        label (``y_spk``). Counts the pairs of every pass in
        ``statistics_training`` (with speakers, also by
        ``<type>SameSpk``/``<type>DiffSpk``), as the JAX loader does."""
        from abnet3_torch.ops.dtw import aligned_frame_pairs
        dev = resolve_device(self.device)
        segs, spk_segs = [], []
        for group in ("same", "diff"):
            collected = self._collect_pair_feats(pairs, token_feats, group)
            if not collected:
                continue
            feats = [f for f, _ in collected]
            is_same = group == "same"
            T1 = pow2_bucket(max(len(a) for a, _ in feats))
            T2 = pow2_bucket(max(len(b) for _, b in feats))
            padded = (_pad_tokens([a for a, _ in feats], T1)
                      + _pad_tokens([b for _, b in feats], T2))
            count(_H2D[train_mode], sum(a.nbytes for a in padded))
            f1, n1, f2, n2 = (torch.from_numpy(a).to(dev) for a in padded)
            segs.append(aligned_frame_pairs(
                f1, f2, n1, n2, is_same,
                align_different_words=self.align_different_words,
                spans=_ALIGN[train_mode]))
            key = "SameType" if is_same else "DiffType"
            self.statistics_training[key] += len(feats)
            if fid2spk is not None:
                same_spk = [fid2spk[p[0]] == fid2spk[p[3]]
                            for _, p in collected]
                spk = np.repeat(
                    np.where(same_spk, 1.0, -1.0).astype(np.float32),
                    segs[-1][0].shape[0] // len(feats))
                count(_H2D[train_mode], spk.nbytes)
                spk_segs.append(torch.from_numpy(spk).to(dev))
                for s in same_spk:
                    self.statistics_training[
                        key + ("SameSpk" if s else "DiffSpk")] += 1
        if not segs:
            return None
        y_spk = torch.cat(spk_segs) if fid2spk is not None else None
        return Batch(*(torch.cat(parts) for parts in zip(*segs)),
                     y_spk=y_spk)

    # -- host batch construction --------------------------------------------

    def load_frames_from_pairs(self, pairs, seed=0, fid2spk=None,
                               frames=False):
        """The reference's host batch (reference dataloader.py:166-261):
        same pairs aligned by host DTW, diff pairs truncated (or
        stretched along the diagonal), all frames stacked and shuffled by
        ``RandomState(seed)``. Returns numpy (X1, X2, y), or with a
        file-to-speaker map (X1, X2, y_spk, y)."""
        token_feats = self.get_token_feats(pairs, frames=frames)
        X1, X2, y_phn, y_spk = [], [], [], []

        def speakers(f1, f2, kind, n):
            if fid2spk:
                same_spk = fid2spk[f1] == fid2spk[f2]
                y_spk.append((1.0 if same_spk else -1.0) * np.ones(n))
                self.statistics_training[
                    kind + ("SameSpk" if same_spk else "DiffSpk")] += 1

        for f1, s1, e1, f2, s2, e2 in pairs["same"]:
            if (s1 > e1) or (s2 > e2):
                continue
            feat1 = token_feats[f1, s1, e1]
            feat2 = token_feats[f2, s2, e2]
            try:
                path1, path2 = get_dtw_alignment(feat1, feat2)
            except ValueError:  # a token of no frames: the pair is skipped
                continue
            self.statistics_training["SameType"] += 1
            speakers(f1, f2, "SameType", len(path1))
            X1.append(feat1[path1, :])
            X2.append(feat2[path2, :])
            y_phn.append(np.ones(len(path1)))

        for f1, s1, e1, f2, s2, e2 in pairs["diff"]:
            if (s1 > e1) or (s2 > e2):
                continue
            feat1 = token_feats[f1, s1, e1]
            feat2 = token_feats[f2, s2, e2]
            n1, n2 = feat1.shape[0], feat2.shape[0]
            if self.align_different_words:
                min_word, max_word = sorted((feat1, feat2), key=len)
                mapping = np.rint(np.linspace(
                    0, len(min_word) - 1, num=len(max_word))).astype(int)
                word1, word2 = max_word, min_word[mapping, :]
            else:
                word1 = feat1[:min(n1, n2), :]
                word2 = feat2[:min(n1, n2), :]
            X1.append(word1)
            X2.append(word2)
            y_phn.append(-1 * np.ones(len(word1)))
            self.statistics_training["DiffType"] += 1
            speakers(f1, f2, "DiffType", len(word1))

        X1, X2 = np.vstack(X1), np.vstack(X2)
        y_phn = np.concatenate(y_phn)
        rng = np.random.RandomState(seed)
        ind = rng.permutation(len(y_phn))
        if fid2spk:
            return X1[ind, :], X2[ind, :], np.concatenate(y_spk)[ind], \
                y_phn[ind]
        return X1[ind, :], X2[ind, :], y_phn[ind]

    def _host_batch(self, X1, X2, y, y_spk=None, train_mode=True) -> Batch:
        """Host frame arrays as a :class:`Batch` on the loader's device
        (float32, every row weight 1); ``train_mode`` names the counter of
        the bytes copied."""
        dev = resolve_device(self.device)

        def put(a):
            a = np.asarray(a, np.float32)
            count(_H2D[train_mode], a.nbytes)
            return torch.from_numpy(a).to(dev)
        y = put(y)
        return Batch(put(X1), put(X2), y,
                     torch.ones(len(y), dtype=torch.float32, device=dev),
                     None if y_spk is None else put(y_spk))

    # -- temporal coherence pairs -------------------------------------------

    def temporal_coherence_loss(self, num_pairs):
        """Close-frame positives (dt=1) and far negatives (dt in
        {15,20,25,30}) drawn from the train files with the global
        ``random`` (reference dataloader.py:324-352)."""
        X1, X2, Y = [], [], []
        per_iter = (len(self.TCL_DISTANCES_DIFF)
                    + len(self.TCL_DISTANCE_SAME))
        files = list(self.features.features.keys())
        if self.train_files is not None:
            files = self.train_files
        max_delta = max(self.TCL_DISTANCES_DIFF)
        for _ in range(round(num_pairs / per_iter)):
            f = random.choice(files)
            file_features = self.features.features[self.features._key(f)]
            if len(file_features) <= max_delta:
                continue
            t = random.randrange(len(file_features) - max_delta)
            for delta in self.TCL_DISTANCE_SAME:
                X1.append(file_features[t])
                X2.append(file_features[t + delta])
                Y.append(1)
            for delta in self.TCL_DISTANCES_DIFF:
                X1.append(file_features[t])
                X2.append(file_features[t + delta])
                Y.append(-1)
        if not X1:
            return (np.zeros((0, 1), np.float32),) * 2 + (np.zeros(0),)
        return np.vstack(X1), np.vstack(X2), np.array(Y, np.float32)

    def add_tcl_to_batch(self, batch):
        """Mix tcl fraction of coherence pairs into a host batch
        (reference dataloader.py:314-322)."""
        X1, X2, Y = batch
        num_pairs = len(Y)
        num_to_add = int((self.tcl * num_pairs) / (1 - self.tcl))
        X1_t, X2_t, Y_t = self.temporal_coherence_loss(num_to_add)
        return (np.vstack((X1, X1_t)), np.vstack((X2, X2_t)),
                np.concatenate((Y, Y_t)))

    def _add_tcl(self, batch: Batch, train_mode: bool = True) -> Batch:
        """Mix tcl fraction of coherence pairs into a device batch, sized
        from its weighted frame count (one host sync)."""
        n_valid = float(batch.weights.sum())
        num_to_add = int((self.tcl * n_valid) / (1 - self.tcl))
        X1_t, X2_t, Y_t = self.temporal_coherence_loss(num_to_add)
        if len(Y_t) == 0:
            return batch
        t = self._host_batch(X1_t, X2_t, Y_t, train_mode=train_mode)
        return Batch(*(torch.cat([a, b]) for a, b in zip(batch[:4], t[:4])))

    def _build_frame_bank(self):
        """Device frame table for temporal-coherence sampling: the train
        files' frames in one (N_frames, d) tensor, so tcl pairs travel as
        index pairs and are gathered inside the step."""
        from abnet3_torch.ops.bank import upload_rows
        files = self.train_files or []
        max_delta = max(self.TCL_DISTANCES_DIFF)
        chunks, self._tcl_files = [], []
        offset = 0
        for f in files:
            feat = self.features.features.get(self.features._key(f))
            if feat is None:
                continue
            if len(feat) > max_delta:
                # anchors stay >= max_delta from the end (reference
                # dataloader.py:337)
                self._tcl_files.append((offset, len(feat) - max_delta))
            chunks.append(np.asarray(feat, np.float32))
            offset += len(feat)
        if not self._tcl_files:
            print("Warning: tcl=%g is a no-op — no train file is longer "
                  "than %d frames" % (self.tcl, max_delta))
            self.frame_bank = None
            return
        self.frame_bank = upload_rows(np.concatenate(chunks, axis=0),
                                      device=self.device)
        # static tcl group size per batch: each anchor yields 1 same +
        # len(TCL_DISTANCES_DIFF) diff pairs; the anchor count
        # approximates tcl/(1-tcl) of the batch's expected frame pairs
        # (the step rescales weights to the exact fraction). The pure-tcl
        # TemporalCoherenceDataLoader has no token bank and sizes its
        # groups from batch_size.
        if self.token_bank is not None and self.tcl > 0:
            per_iter = (len(self.TCL_DISTANCE_SAME)
                        + len(self.TCL_DISTANCES_DIFF))
            mean_len = float(self.token_bank.lengths_host.mean())
            approx_frames = self.batch_size * 1.25 * mean_len
            self._tcl_anchors = max(1, round(
                self.tcl / (1.0 - self.tcl) * approx_frames / per_iter))
        else:
            self._tcl_anchors = None

    def _sample_tcl_group(self, n_anchors=None):
        """One static-size tcl index group: close positives (dt=1), far
        negatives (dt in {15,20,25,30}), anchors uniform over files then
        over time, drawn from ``self._rng`` (reference
        dataloader.py:333-352)."""
        files = self._tcl_files
        if n_anchors is None:
            n_anchors = self._tcl_anchors
        i1, i2, y = [], [], []
        for fi in self._rng.randint(len(files), size=n_anchors):
            off, max_t = files[fi]
            a = off + self._rng.randint(max_t)
            for dt in self.TCL_DISTANCE_SAME:
                i1.append(a); i2.append(a + dt); y.append(1.0)
            for dt in self.TCL_DISTANCES_DIFF:
                i1.append(a); i2.append(a + dt); y.append(-1.0)
        return (np.asarray(i1, np.int32), np.asarray(i2, np.int32),
                np.asarray(y, np.float32),
                np.ones(len(y), np.float32))


class PairsDataLoader(OriginalDataLoader):
    """Numeric-frame KNN pair files, ``f1 f2 b1 e1 b2 e2 dist`` with frame
    indices (reference dataloader.py:355-546). Its splits are ``train``
    and ``test``; ``batch_iterator`` draws from the global ``random``."""

    SPLIT_FILES = "files"
    SPLIT_EACH_FILE = "split_each_file"
    SPLIT_METHODS = [SPLIT_FILES, SPLIT_EACH_FILE]

    # iteration counts live in the self.iterations dict
    _WHOAMI_ALIASES = {
        "train_iterations": lambda s: s.iterations["train"],
        "test_iterations": lambda s: s.iterations["test"],
    }

    def __init__(self, pairs_path, features_path, id_to_file,
                 ratio_split_train_test=0.7, batch_size=8,
                 train_iterations=10000, test_iterations=500,
                 proportion_positive_pairs=0.5,
                 align_different_words=True,
                 split_method=SPLIT_EACH_FILE,
                 align_backend="device", device=None):
        super().__init__(pairs_path, features_path, batch_size=batch_size,
                         align_different_words=align_different_words,
                         align_backend=align_backend, device=device)
        self.id_to_file = id_to_file
        self.pairs = {"train": None, "test": None}
        self.ratio_split_train_test = ratio_split_train_test
        self.iterations = {"train": train_iterations,
                           "test": test_iterations}
        self.proportion_positive_pairs = proportion_positive_pairs
        if split_method not in self.SPLIT_METHODS:
            raise ValueError(f"split_method must be one of "
                             f"{self.SPLIT_METHODS}, got {split_method!r}")
        self.split_method = split_method
        self.tokens = {"train": [], "test": []}
        self.files = set()
        self.seed = 0

    def load_data(self):
        if self.pairs["train"] is None:
            self.load_pairs()
        if self.features is None:
            print("Loading features")
            features, _, _ = read_feats(self.features_path)
            self.features = features
        if self.align_backend == "bank" and self.token_bank is None:
            from abnet3_torch.ops.bank import TokenBank
            token_feats = {}
            for mode in ("train", "test"):
                for key in self.tokens[mode]:
                    f, b, e = key
                    feat = self.features.get_between_frames(f, b, e)
                    if len(feat) > 0:
                        token_feats[key] = feat
            print("Uploading %d tokens to the device token bank"
                  % len(token_feats))
            self.token_bank = TokenBank(token_feats, device=self.device)

    def load_pairs(self):
        """Parse ``f1 f2 b1 e1 b2 e2 dist`` integer-frame pair lines with
        the optional id -> file name mapping (reference
        dataloader.py:430-462)."""
        pairs = []
        file_mapping = {}
        if self.id_to_file is not None:
            with open(self.id_to_file, "r") as f:
                for line in f:
                    i, name = line.strip().split()
                    file_mapping[int(i)] = name
        with open(self.pairs_path, "r") as f:
            for line in f:
                file1, file2, b1, e1, b2, e2, _dist = line.split(" ")
                file1 = file_mapping.get(int(file1), int(file1))
                file2 = file_mapping.get(int(file2), int(file2))
                self.files.add(file1)
                self.files.add(file2)
                pairs.append([file1, int(b1), int(e1),
                              file2, int(b2), int(e2)])
        if self.split_method == self.SPLIT_FILES:
            self.pairs["train"], self.pairs["test"] = \
                self.split_train_test(pairs)
        else:
            self.pairs["train"], self.pairs["test"] = \
                self.split_train_test_each_file(pairs)
        for mode in ("train", "test"):
            toks = set()
            for f1, b1, e1, f2, b2, e2 in self.pairs[mode]:
                toks.add((f1, b1, e1))
                toks.add((f2, b2, e2))
            self.tokens[mode] = sorted(toks, key=str)

    def split_train_test(self, pairs):
        """File-level split with the global ``random``; cross pairs
        dropped (reference dataloader.py:464-481)."""
        num_test = int(len(self.files) * (1 - self.ratio_split_train_test))
        dev_files = set(random.sample(sorted(self.files, key=str),
                                      num_test))
        print("Dev-split files: %s" % dev_files)
        train_pairs, dev_pairs = [], []
        for pair in pairs:
            f1, _, _, f2, _, _ = pair
            if f1 in dev_files and f2 in dev_files:
                dev_pairs.append(pair)
            elif f1 not in dev_files and f2 not in dev_files:
                train_pairs.append(pair)
        return train_pairs, dev_pairs

    def split_train_test_each_file(self, pairs):
        """Time split within each file (reference dataloader.py:483-505)."""
        len_files = defaultdict(int)
        for f1, b1, e1, f2, b2, e2 in pairs:
            len_files[f1] = max(len_files[f1], e1)
            len_files[f2] = max(len_files[f2], e2)
        thr = {f: l * self.ratio_split_train_test
               for f, l in len_files.items()}
        train_pairs, dev_pairs = [], []
        for p in pairs:
            f1, b1, e1, f2, b2, e2 = p
            if b1 > thr[f1] and b2 > thr[f2]:
                dev_pairs.append(p)
            elif b1 < thr[f1] and b2 <= thr[f2]:
                train_pairs.append(p)
        return train_pairs, dev_pairs

    def batch_iterator(self, train_mode=True):
        """Sample positive pairs + random-token negatives with the global
        ``random`` (reference dataloader.py:507-546)."""
        print("building pair batches")
        mode = "train" if train_mode else "test"
        self.load_data()
        iterations = self.iterations[mode]
        all_positive = self.pairs[mode]
        tokens = self.tokens[mode]

        num_pairs = iterations * self.batch_size
        num_pos = int(num_pairs * self.proportion_positive_pairs)
        if num_pos > len(all_positive):
            print("positive-pair budget capped: requested {} but the "
                  "corpus only has {}".format(num_pos, len(all_positive)))
            num_pos = len(all_positive)
        num_neg = num_pairs - num_pos
        positive = [p + ["same"]
                    for p in random.sample(all_positive, num_pos)]
        toks = random.choices(tokens, k=2 * num_neg)
        negative = [list(toks[i]) + list(toks[i + 1]) + ["diff"]
                    for i in range(0, len(toks), 2)]
        pairs = positive + negative
        random.shuffle(pairs)
        print("pair batches ready for this epoch")
        for i in range(iterations):
            chunk = pairs[i * self.batch_size:(i + 1) * self.batch_size]
            if not chunk:
                break
            if self.align_backend == "bank":
                batch = self._bank_batch_from_pairs(chunk)
                if batch is not None:
                    yield batch
                continue
            grouped = group_pairs([tuple(p) for p in chunk])
            if self.align_backend == "device":
                token_feats = self.get_token_feats(grouped, frames=True)
                batch = self._assemble_device(grouped, token_feats)
                if batch is not None:
                    yield batch
            else:
                yield self._host_batch(*self.load_frames_from_pairs(
                    grouped, frames=True))

    def _bank_batch_from_pairs(self, chunk):
        """Sampled (f1, b1, e1, f2, b2, e2, type) pairs as a fixed-shape
        BankBatch of token ids."""
        kid = self.token_bank.key_to_id
        ids1, ids2, ys = [], [], []
        for f1, b1, e1, f2, b2, e2, ptype in (tuple(p) for p in chunk):
            k1, k2 = (f1, b1, e1), (f2, b2, e2)
            if k1 not in kid or k2 not in kid:
                continue
            ids1.append(kid[k1])
            ids2.append(kid[k2])
            ys.append(1.0 if ptype == "same" else -1.0)
        if not ids1:
            return None
        bs = self.batch_size
        n = len(ids1)
        w = np.ones(bs, np.float32)
        pad = bs - n
        if pad:
            ids1 += [0] * pad
            ids2 += [0] * pad
            ys += [1.0] * pad
            w[n:] = 0.0
        lens = self.token_bank.lengths_host
        i1 = np.asarray(ids1, np.int32)
        i2 = np.asarray(ids2, np.int32)
        bucket = self.token_bank.bucket_for(
            int(np.maximum(lens[i1[:n]], lens[i2[:n]]).max()))
        return BankBatch(i1, i2, np.asarray(ys, np.float32), w,
                         bucket=bucket)


class TemporalCoherenceDataLoader(OriginalDataLoader):
    """Trains on temporal-coherence pairs only; the dev pass uses the word
    pairs at ``test_words_batch_size`` (reference dataloader.py:549-577).
    On the device and bank backends the train batches are
    :class:`FrameBankBatch` index groups into the frame bank; on the host
    backend they are frames drawn with the global ``random``."""

    def __init__(self, pairs_path, features_path, batch_size=500,
                 test_words_batch_size=8, num_max_minibatches=1000,
                 align_backend="device", steps_per_call=8, device=None):
        super().__init__(pairs_path, features_path,
                         num_max_minibatches=num_max_minibatches,
                         batch_size=test_words_batch_size,
                         align_backend=align_backend,
                         steps_per_call=steps_per_call, device=device)
        self.test_words_batch_size = test_words_batch_size
        self.batch_size = batch_size

    def frame_tables(self, train_mode=True):
        """The tcl frame bank is the (single) frame table: train batches
        are index groups into it (dev uses word-pair batches)."""
        self.load_data()
        if self.frame_bank is None:
            self._build_frame_bank()
        return (self.frame_bank,)

    def batch_iterator(self, train_mode=True):
        self.load_data()
        if train_mode and self.align_backend != "host":
            if self.frame_bank is None:
                self._build_frame_bank()
            if self.frame_bank is not None:
                per_iter = (len(self.TCL_DISTANCE_SAME)
                            + len(self.TCL_DISTANCES_DIFF))
                anchors = max(1, round(self.batch_size / per_iter))
                for _ in range(self.num_max_minibatches):
                    i1, i2, y, w = self._sample_tcl_group(anchors)
                    yield FrameBankBatch(i1, i2, y, w, mode="train")
                return
            # no train file is long enough for tcl pairs: fall through
        if train_mode:
            for _ in range(self.num_max_minibatches):
                X1, X2, Y = self.temporal_coherence_loss(
                    num_pairs=self.batch_size)
                if len(Y) == 0:
                    continue
                yield self._host_batch(X1, X2, Y)
        else:
            # the dev pass takes the word-pair batches at the word batch
            # size
            saved = self.batch_size
            self.batch_size = self.test_words_batch_size
            try:
                yield from super().batch_iterator(train_mode)
            finally:
                self.batch_size = saved


class FramesDataLoader(OriginalDataLoader):
    """Epoch-level frame shuffling: every pair is aligned once (on the
    device, in chunks of ``align_chunk`` same pairs at power-of-two
    buckets), its frame-index pairs stored against one concatenated
    feature table per split, then fixed-size frame batches are yielded
    (reference dataloader.py:580-739 built the same frame list with
    per-pair host DTW). On the device and bank backends a batch is a
    :class:`FrameBankBatch` against the table on the device; on the host
    backend the frames are gathered on the host."""

    def __init__(self, pairs_path, features_path, batch_size=100,
                 randomize_dataset=True, max_batches_per_epoch=None,
                 align_backend="device", align_chunk=256,
                 steps_per_call=8, device=None):
        super().__init__(pairs_path, features_path,
                         align_backend=align_backend,
                         steps_per_call=steps_per_call, device=device)
        self.randomize_dataset = randomize_dataset
        self.batch_size = batch_size
        self.max_batches_per_epoch = max_batches_per_epoch
        self.align_chunk = align_chunk
        self.token_features = {"train": None, "dev": None}
        self.frame_pairs = {"train": None, "dev": None}
        self._tables_dev = {"train": None, "dev": None}
        if self.max_batches_per_epoch is not None:
            self.batch_position = 0

    def load_data(self):
        super().load_data()
        for mode in ("train", "dev"):
            if self.token_features[mode] is None:
                print(f"Loading all frames ({mode})..", end="", flush=True)
                self.token_features[mode], self.frame_pairs[mode] = \
                    self.load_all_frames(self.pairs[mode])
                print(" Done. %s frame pairs in total."
                      % len(self.frame_pairs[mode]))

    def _token_table(self, pairs):
        """Concatenate unique token features into one (N, d) table with a
        token -> row-offset index."""
        grouped = group_pairs(pairs)
        token_feats = self.get_token_feats(grouped)
        offsets = {}
        mats = []
        pos = 0
        for k, f in token_feats.items():
            offsets[k] = pos
            pos += len(f)
            mats.append(f)
        table = np.vstack(mats).astype(np.float32) if mats else \
            np.zeros((0, 1), np.float32)
        return grouped, token_feats, offsets, table

    def load_all_frames(self, pairs):
        """Return (feature table, frame-index pairs): an int array (P, 3)
        of (row1, row2, label), shuffled by ``self._rng``. Same pairs are
        aligned on the loader's device (the move kernel on the card), one
        launch per chunk of ``align_chunk`` pairs."""
        from abnet3_torch.ops.dtw import dtw_align_batch
        dev = resolve_device(self.device)
        grouped, token_feats, offsets, table = self._token_table(pairs)
        idx1, idx2, labels = [], [], []

        collected = self._collect_pair_feats(grouped, token_feats, "same")
        same = [f for f, _ in collected]
        same_keys = [(p[:3], p[3:]) for _, p in collected]
        for c0 in range(0, len(same), self.align_chunk):
            chunk = same[c0:c0 + self.align_chunk]
            kchunk = same_keys[c0:c0 + self.align_chunk]
            T1 = pow2_bucket(max(len(a) for a, _ in chunk))
            T2 = pow2_bucket(max(len(b) for _, b in chunk))
            f1p, n1 = _pad_tokens([a for a, _ in chunk], T1)
            f2p, n2 = _pad_tokens([b for _, b in chunk], T2)
            p1, p2, plen = dtw_align_batch(
                *(torch.from_numpy(a).to(dev) for a in (f1p, f2p, n1, n2)))
            # int32 paths, as the JAX package's
            p1, p2, plen = (t.to(torch.int32).cpu().numpy()
                            for t in (p1, p2, plen))
            for b, (k1, k2) in enumerate(kchunk):
                L = int(plen[b])
                idx1.append(offsets[k1] + p1[b, :L])
                idx2.append(offsets[k2] + p2[b, :L])
                labels.append(np.ones(L, np.int32))
                self.statistics_training["SameType"] += 1

        for f1, s1, e1, f2, s2, e2 in grouped["diff"]:
            if (s1 > e1) or (s2 > e2):
                continue
            n1 = len(token_feats[f1, s1, e1])
            n2 = len(token_feats[f2, s2, e2])
            n = min(n1, n2)
            if n == 0:
                continue
            idx1.append(offsets[f1, s1, e1] + np.arange(n))
            idx2.append(offsets[f2, s2, e2] + np.arange(n))
            labels.append(-np.ones(n, np.int32))
            self.statistics_training["DiffType"] += 1

        if idx1:
            frames = np.stack([np.concatenate(idx1),
                               np.concatenate(idx2),
                               np.concatenate(labels)], axis=1)
        else:
            frames = np.zeros((0, 3), np.int64)
        self._rng.shuffle(frames)
        return table, frames

    def _epoch_batch_ids(self, mode, num_batches):
        if mode == "dev" or self.max_batches_per_epoch is None:
            if self.randomize_dataset:
                self._rng.shuffle(self.frame_pairs[mode])
            return range(num_batches)
        if self.batch_position >= num_batches:
            print("Arrived at the end of the dataset. Starting over.")
            if self.randomize_dataset:
                self._rng.shuffle(self.frame_pairs[mode])
            self.batch_position = 0
        ids = range(self.batch_position,
                    min(self.batch_position + self.max_batches_per_epoch,
                        num_batches))
        self.batch_position += self.max_batches_per_epoch
        return ids

    def frame_tables(self, train_mode=True):
        """The split's frame table on the loader's device, copied once
        (read by ``parallel.make_frame_train_step``)."""
        from abnet3_torch.ops.bank import upload_rows
        self.load_data()
        mode = "train" if train_mode else "dev"
        if self._tables_dev.get(mode) is None:
            self._tables_dev[mode] = (upload_rows(
                np.asarray(self.token_features[mode]), device=self.device),)
        return self._tables_dev[mode]

    def _index_batches(self, mode):
        """Fixed-shape FrameBankBatch index batches (ragged tails pad
        with weight 0)."""
        frames = self.frame_pairs[mode]
        bs = self.batch_size
        num_batches = max(len(frames) // bs, 1)
        for i in self._epoch_batch_ids(mode, num_batches):
            chunk = frames[i * bs:(i + 1) * bs]
            n = len(chunk)
            if n == 0:
                continue
            w = np.ones(bs, np.float32)
            if n < bs:
                w[n:] = 0.0
                chunk = np.vstack([chunk, np.zeros((bs - n, 3),
                                                   chunk.dtype)])
            yield FrameBankBatch(chunk[:, 0].astype(np.int32),
                                 chunk[:, 1].astype(np.int32),
                                 chunk[:, 2].astype(np.float32), w,
                                 mode=mode)

    def batch_iterator(self, train_mode=True):
        self.load_data()
        mode = "train" if train_mode else "dev"
        if self.align_backend != "host":
            self.frame_tables(train_mode)
            yield from self._index_batches(mode)
            return
        frames = self.frame_pairs[mode]
        table = self.token_features[mode]
        num_batches = max(len(frames) // self.batch_size, 1)
        for i in self._epoch_batch_ids(mode, num_batches):
            chunk = frames[i * self.batch_size:(i + 1) * self.batch_size]
            if len(chunk) == 0:
                continue
            yield self._host_batch(table[chunk[:, 0]], table[chunk[:, 1]],
                                   chunk[:, 2])


class MultiTaskDataLoader(OriginalDataLoader):
    """Adds speaker labels for the multitask network (reference
    dataloader.py:742-792): every pair's +1/-1 same/different-speaker
    label from ``fid2spk_file`` (``fid spkid`` lines), as ``y_spk`` of
    the device and host backends' :class:`Batch` and of the bank
    backend's index batches. The device backend mixes no tcl pairs, as in
    the JAX package; tcl on the bank backend is refused by the multitask
    steps."""

    def __init__(self, pairs_path, features_path, fid2spk_file=None,
                 **kwargs):
        super().__init__(pairs_path, features_path, **kwargs)
        self.fid2spk_file = fid2spk_file

    def _build_token_bank(self, fid2spk=None):
        if fid2spk is None:
            fid2spk = read_spkid_file(self.fid2spk_file)
        super()._build_token_bank(fid2spk=fid2spk)

    def batch_iterator(self, train_mode=True):
        self.load_data()
        if self.align_backend == "bank":
            yield from self.bank_batch_iterator(train_mode)
            return
        mode = "train" if train_mode else "dev"
        fid2spk = read_spkid_file(self.fid2spk_file)
        batches, selected = self._select_batches(list(self.pairs[mode]))
        n = 0
        for idx in selected:
            with span(_BUILD[train_mode], n):
                grouped = group_pairs(batches[idx])
                if self.align_backend == "device":
                    batch = self.load_frames_from_pairs_device(
                        grouped, fid2spk=fid2spk, train_mode=train_mode)
                else:
                    X1, X2, y_spk, y_phn = self.load_frames_from_pairs(
                        grouped, fid2spk=fid2spk)
                    batch = self._host_batch(X1, X2, y_phn, y_spk,
                                             train_mode=train_mode)
            if batch is None:
                continue
            n += 1
            yield batch


class MultimodalDataLoader(FramesDataLoader):
    """Frame batches over several feature sets, one per modality
    (reference dataloader.py:794-980): ``features_path`` is a list, and
    ``features_dict`` maps each of its entries to a
    :class:`~abnet3_torch.utils.Features_Accessor` (read from the files,
    or set by the caller before :meth:`load_data`). The pairs are aligned
    on the first modality only (:meth:`FramesDataLoader.load_all_frames`,
    one move-kernel launch per chunk of ``align_chunk`` same pairs on the
    card); the other modalities' token tables take the same row layout,
    which needs equal per-token frame counts across modalities (as the
    reference assumes; a mismatch raises). The device and bank backends
    yield :class:`FrameBankBatch`es against one device table per
    modality (:meth:`frame_tables`); the host backend yields
    :class:`Batch`es whose ``x1``/``x2`` are per-modality lists."""

    _HEAVY_MODE_DICTS = FramesDataLoader._HEAVY_MODE_DICTS + (
        "token_tables",)

    def __init__(self, pairs_path, features_path, batch_size=500,
                 randomize_dataset=False, max_batches_per_epoch=None,
                 align_backend="device", steps_per_call=8, align_chunk=256,
                 device=None):
        assert isinstance(features_path, (list, tuple)), \
            "MultimodalDataLoader takes a list of feature paths"
        super().__init__(pairs_path, features_path, batch_size,
                         randomize_dataset, max_batches_per_epoch,
                         align_backend=align_backend, align_chunk=align_chunk,
                         steps_per_call=steps_per_call, device=device)
        self.features_dict = None
        self.token_tables = {"train": None, "dev": None}
        self._read_features = False

    def __getstate__(self):
        d = super().__getstate__()
        if self._read_features:  # load_data() reads them again
            d["features_dict"] = None
        return d

    def load_data(self):
        if self.features_dict is None:
            print("Loading features")
            self.features_dict = {}
            for path in self.features_path:
                self.features_dict[path], _, _ = read_feats(path)
            self._read_features = True
        if self.pairs["train"] is None:
            print("Loading word pairs")
            self.pairs["train"] = read_dataset(
                os.path.join(self.pairs_path, "train_pairs/dataset"))
            self.pairs["dev"] = read_dataset(
                os.path.join(self.pairs_path, "dev_pairs/dataset"))
        for mode in ("train", "dev"):
            if self.token_tables[mode] is None:
                # alignment on the first modality
                first = self.features_path[0]
                self.features = self.features_dict[first]
                table0, frames = self.load_all_frames(self.pairs[mode])
                _, _, offsets0, _ = self._token_table(self.pairs[mode])
                tables = [table0]
                # the same token row layout for the other modalities
                for path in self.features_path[1:]:
                    self.features = self.features_dict[path]
                    _, feats, offsets, table = self._token_table(
                        self.pairs[mode])
                    if offsets != offsets0 or len(table) != len(table0):
                        bad = next((k for k in feats
                                    if offsets.get(k) != offsets0.get(k)),
                                   None)
                        raise ValueError(
                            f"modality {path!r} has {len(table)} token "
                            f"frames ({mode}) where {first!r} has "
                            f"{len(table0)} (first differing token near "
                            f"{bad}): MultimodalDataLoader needs equal "
                            "per-token frame counts across modalities")
                    tables.append(table)
                self.token_tables[mode] = tables
                self.frame_pairs[mode] = frames

    def frame_tables(self, train_mode=True):
        """One table per modality on the loader's device, each copied
        once."""
        from abnet3_torch.ops.bank import upload_rows
        self.load_data()
        mode = "train" if train_mode else "dev"
        if self._tables_dev.get(mode) is None:
            self._tables_dev[mode] = tuple(
                upload_rows(np.asarray(t), device=self.device)
                for t in self.token_tables[mode])
        return self._tables_dev[mode]

    def batch_iterator(self, train_mode=True):
        self.load_data()
        mode = "train" if train_mode else "dev"
        if self.align_backend != "host":
            self.frame_tables(train_mode)
            yield from self._index_batches(mode)
            return
        dev = resolve_device(self.device)
        frames = self.frame_pairs[mode]
        tables = self.token_tables[mode]
        num_batches = max(len(frames) // self.batch_size, 1)
        for i in self._epoch_batch_ids(mode, num_batches):
            chunk = frames[i * self.batch_size:(i + 1) * self.batch_size]
            if len(chunk) == 0:
                continue
            x1 = [torch.from_numpy(t[chunk[:, 0]]).to(dev) for t in tables]
            x2 = [torch.from_numpy(t[chunk[:, 1]]).to(dev) for t in tables]
            y = torch.from_numpy(chunk[:, 2].astype(np.float32)).to(dev)
            yield Batch(x1, x2, y, torch.ones(len(chunk), dtype=torch.float32,
                                              device=dev))


class OnDeviceSamplerDataLoader(OriginalDataLoader):
    """The fully on-device data pipeline: no pair files at all
    (``abnet3_tpu/dataloader.py:1290-1392``).

    ``load_data`` runs the cluster analysis itself
    (:class:`abnet3_torch.sampler.SamplerClusterSiamese`: the ``.classes``
    file, the spkid file, the train/dev split of ``split_method``, which
    draws from the global ``np.random``/``random`` as the JAX loader's
    does), then holds per split a :class:`~abnet3_torch.ops.bank.TokenBank`
    of its tokens in descr order and a
    :class:`~abnet3_torch.ops.sampling.DevicePairSampler` of its
    P(type, speaker) distributions, both on ``device``. The trainer's
    sampled steps draw their pairs from them on the card
    (:func:`abnet3_torch.parallel.make_sampled_train_step`); the host
    sends a seed per call of ``steps_per_call`` steps. ``pairs_path`` is
    accepted and ignored (the gridsearch passes one); pair it with
    ``DummySampler`` in a YAML."""

    def __init__(self, features_path, std_file=None, spkid_file=None,
                 batch_size=64, num_max_minibatches=1000,
                 ratio_train_dev=0.7, ratio_same_diff_spk=0.5,
                 ratio_same_diff_type=0.5, type_sampling_mode="log",
                 spk_sampling_mode="log", max_size_cluster=10,
                 max_num_clusters=None, split_method="clusters",
                 seed=0, pairs_path=None, steps_per_call=8, device=None):
        super().__init__(pairs_path, features_path,
                         num_max_minibatches=num_max_minibatches,
                         seed=seed, batch_size=batch_size,
                         align_backend="bank", steps_per_call=steps_per_call,
                         device=device)
        self.std_file = std_file
        self.spkid_file = spkid_file
        self.ratio_train_dev = ratio_train_dev
        self.ratio_same_diff_spk = ratio_same_diff_spk
        self.ratio_same_diff_type = ratio_same_diff_type
        self.type_sampling_mode = str(type_sampling_mode)
        self.spk_sampling_mode = str(spk_sampling_mode)
        self.max_size_cluster = max_size_cluster
        self.max_num_clusters = max_num_clusters
        self.split_method = split_method
        self.device_samplers = None  # {'train': ..., 'dev': ...}
        self._banks = None

    def load_data(self):
        if self.device_samplers is not None:
            return
        from abnet3_torch.ops.bank import TokenBank
        from abnet3_torch.ops.sampling import DevicePairSampler
        from abnet3_torch.sampler import SamplerClusterSiamese
        from abnet3_torch.utils import read_spkid_file

        if self.features is None:
            print("Loading features")
            self.features, _, _ = read_feats(self.features_path)
        sampler = SamplerClusterSiamese(
            std_file=self.std_file, spkid_file=self.spkid_file,
            ratio_train_dev=self.ratio_train_dev,
            max_size_cluster=self.max_size_cluster,
            split_method=self.split_method, seed=self.seed)
        spkid = read_spkid_file(self.spkid_file)
        sampler.spkid_from_file = spkid
        clusters = sampler.parse_input_file(self.std_file,
                                            self.max_num_clusters)
        if self.split_method == "clusters":
            splits = sampler.split_clusters_ratio(clusters)
        elif self.split_method == "files":
            splits = sampler.split_clusters_on_file(clusters)
        else:
            splits = sampler.split_each_file(clusters)

        samplers, banks = {}, {}
        for mode, cs in zip(("train", "dev"), splits):
            descr = sampler.analyze_clusters(cs, spkid)
            proba = sampler.type_speaker_sampling_p(
                descr, type_sampling_mode=self.type_sampling_mode,
                spk_sampling_mode=self.spk_sampling_mode)
            token_feats = {}
            for tid, (fid, t0, t1) in enumerate(descr["tokens"]):
                f = self.features.get(fid, t0, t1)
                if len(f) == 0:
                    f = np.zeros((1, self.features.features[
                        self.features._key(fid)].shape[1]), np.float32)
                token_feats[tid] = f
            banks[mode] = TokenBank(token_feats, device=self.device)
            samplers[mode] = DevicePairSampler(
                descr, proba, batch_size=self.batch_size,
                ratio_same_diff_spk=self.ratio_same_diff_spk,
                ratio_same_diff_type=self.ratio_same_diff_type,
                device=self.device)
        self._banks = banks
        self.device_samplers = samplers

    def bank_for(self, train_mode=True):
        self.load_data()
        return self._banks["train" if train_mode else "dev"]

    def sampler_for(self, train_mode=True):
        self.load_data()
        return self.device_samplers["train" if train_mode else "dev"]

    def steps_per_epoch(self, train_mode=True):
        """Steps of a train pass (``num_max_minibatches``) and of a dev
        pass (a tenth of it, at least 1)."""
        return self.num_max_minibatches if train_mode else \
            max(self.num_max_minibatches // 10, 1)

    def batch_iterator(self, train_mode=True):
        raise TypeError(
            "OnDeviceSamplerDataLoader has no host batch iterator: the "
            "pairs are drawn inside the sampled train step; train it with "
            "TrainerSiamese, which detects it.")
