"""Embedders: trained network -> h5features embedding export.

The counterpart of ``abnet3_tpu/embedder.py``'s ``EmbedderBuilder``,
``EmbedderSiamese`` and ``EmbedderSiameseMultitask`` (reference
embedder.py:19-149). All files' frames form
one stream cut into fixed-size chunks across file boundaries, so a corpus
costs ``ceil(total_frames / batch_size)`` forwards however its frames are
split into files; the tail chunk pads to a short ladder of sizes by
repeating its last valid row. Only one branch runs, in ``eval()`` mode
under ``torch.no_grad()``, on the network's device; the multitask
network's two heads ride the same chunks.

Not ported yet (they raise ``NotImplementedError``): the wire codecs
(``transfer_dtype`` other than ``"float32"``), ``streaming=True``, the
data-parallel ``mesh``, and the multimodal embedder.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from abnet3_torch.profiling import stage_trace
from abnet3_torch.utils import resolve_device

__all__ = ["EmbedderBuilder", "EmbedderSiamese", "EmbedderSiameseMultitask"]


class EmbedderBuilder:
    """Generic embedder (reference embedder.py:19-50). The forward runs on
    the card unless ``cuda=False`` or ``device="cpu"``; the network must
    live on that device."""

    def __init__(self, network=None, network_path=None, feature_path=None,
                 output_path=None, cuda=True, batch_size=5000, mesh=None,
                 transfer_dtype="float32", streaming=False, device=None):
        if network is None:
            raise ValueError("network is None.")
        assert transfer_dtype in ("float32", "bfloat16", "int8", "int4")
        for name, value, default in (("transfer_dtype", transfer_dtype,
                                      "float32"),
                                     ("streaming", streaming, False),
                                     ("mesh", mesh, None)):
            if value != default:
                raise NotImplementedError(
                    f"EmbedderBuilder({name}={value!r}) is not ported to "
                    "abnet3_torch yet")
        self.network = network
        self.network_path = network_path
        self.feature_path = feature_path
        self.output_path = output_path
        self.cuda = cuda
        self.device = resolve_device(device, cuda)
        self.mesh = mesh
        self.transfer_dtype = transfer_dtype
        self.streaming = streaming
        self.batch_size = batch_size

    def _load(self):
        if self.network_path is not None:
            self.network.load_network(self.network_path)
        else:
            self.network.ensure_init()
        if self.network.device != self.device:
            raise ValueError(f"the network lives on {self.network.device}, "
                             f"the embedder runs on {self.device}")
        print("Done loading network weights")

    def _forward_fn(self):
        """(rows, d) float32 tensor on the network's device -> (rows, d_out)
        embeddings (a tuple of them, one a head, for the multitask
        network), one branch in eval mode (the network's mode is restored
        after each call)."""
        network = self.network

        @torch.no_grad()
        def forward(x):
            was_training = network.training
            network.eval()
            try:
                return network.forward_once(x)
            finally:
                network.train(was_training)

        return forward

    def _pad_target(self, n: int) -> int:
        """Padded row count for a tail chunk: the smallest rung of a /4
        ladder under batch_size (floored at 256 rows) that holds ``n``;
        full chunks stay at batch_size. A short tail does not pay for a
        full chunk of padding, and the chunk shapes stay few."""
        floor = 256
        sizes = [self.batch_size]
        while sizes[-1] // 4 >= floor:
            sizes.append(sizes[-1] // 4)
        for s in sorted(sizes):
            if n <= s:
                return s
        return self.batch_size

    def _embed_corpus(self, forward, feats_list, n_outputs: int = 1):
        """Embed every file's frames through fixed-size padded chunks.

        PACKED: the files' frames form one stream and chunks are cut from
        it across file boundaries (every forward is row-independent in eval
        mode). The tail chunk pads to the :meth:`_pad_target` ladder by
        repeating its last valid row; pad rows are dropped. Up to
        ``window`` chunks are in flight on the device before the oldest is
        copied back, so the host cuts the next chunk while the card runs.
        Returns one float32 (n_frames_i, d_out) array per file; with
        ``n_outputs`` > 1 ``forward`` returns a tuple of that many heads
        and this a tuple of one such list per head."""
        bs = self.batch_size
        lens = [len(f) for f in feats_list]
        offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        total = int(offsets[-1])
        device = self.network.device

        def heads(emb):
            return (emb,) if n_outputs == 1 else tuple(emb)

        def per_file(outs):
            lists = [[o[offsets[i]:offsets[i + 1]]
                      for i in range(len(feats_list))] for o in outs]
            return lists[0] if n_outputs == 1 else tuple(lists)

        if total == 0:
            # all-empty corpus: one zero forward gives the output width (a
            # (0, 0) feature set writes a malformed h5features container)
            dims = [f.shape[1] for f in feats_list
                    if getattr(f, "ndim", 0) == 2]
            d_out = [0] * n_outputs
            if feats_list and len(dims) == len(feats_list):
                d_out = [e.shape[1] for e in heads(forward(torch.zeros(
                    (self._pad_target(1), dims[0]), dtype=torch.float32,
                    device=device)))]
            return per_file([np.zeros((0, d), np.float32) for d in d_out])
        out = None  # per head (total, d_out), sized at the first drain
        window = 16
        pending = []  # (row_start, valid_rows, device output)

        def drain_one():
            nonlocal out
            c0, valid, emb = pending.pop(0)
            hosts = [e[:valid].float().cpu().numpy() for e in heads(emb)]
            if out is None:
                out = [np.empty((total, h.shape[1]), np.float32)
                       for h in hosts]
            for o, h in zip(out, hosts):
                o[c0:c0 + valid] = h

        fi = 0
        for c0 in range(0, total, bs):
            valid = min(bs, total - c0)
            target = bs if valid == bs else self._pad_target(valid)
            pieces = []
            got = 0
            while got < valid:
                while lens[fi] <= c0 + got - offsets[fi]:
                    fi += 1  # skip exhausted / empty files
                a = c0 + got - offsets[fi]
                take = min(lens[fi] - a, valid - got)
                pieces.append(np.asarray(feats_list[fi][a:a + take],
                                         np.float32))
                got += take
            chunk = pieces[0] if len(pieces) == 1 else np.concatenate(pieces)
            if target > valid:
                chunk = np.vstack([chunk, np.repeat(chunk[-1:],
                                                    target - valid, axis=0)])
            x = torch.from_numpy(np.ascontiguousarray(chunk)).to(device)
            pending.append((c0, valid, forward(x)))
            if len(pending) >= window:
                drain_one()
        while pending:
            drain_one()
        return per_file(out)

    def embed(self):
        raise NotImplementedError("Unimplemented embed for class:",
                                  self.__class__.__name__)


class EmbedderSiamese(EmbedderBuilder):
    """Monotask embedding export (reference embedder.py:53-100): reads
    ``feature_path`` and writes ``output_path``, both h5features."""

    def embed(self):
        from abnet3_torch.io.h5f import read_h5features, write_h5features
        self._load()
        forward = self._forward_fn()
        data = read_h5features(self.feature_path, "features")
        print("Done loading input feature file")
        with stage_trace("embed"):
            embeddings = self._embed_corpus(forward, data.features())
        if os.path.exists(self.output_path):
            os.remove(self.output_path)
        write_h5features(self.output_path, "features", data.items(),
                         data.labels(), embeddings)


class EmbedderSiameseMultitask(EmbedderBuilder):
    """Multitask embedding export (reference embedder.py:103-149): reads
    ``feature_path`` and writes the speaker head's embeddings to
    ``output_path + ".spk"`` and the phone head's to ``output_path +
    ".phn"``, both h5features."""

    def embed(self):
        from abnet3_torch.io.h5f import read_h5features, write_h5features
        self._load()
        forward = self._forward_fn()
        data = read_h5features(self.feature_path, "features")
        with stage_trace("embed"):
            emb_spk, emb_phn = self._embed_corpus(forward, data.features(),
                                                  n_outputs=2)
        for suffix, embs in ((".spk", emb_spk), (".phn", emb_phn)):
            path = self.output_path + suffix
            if os.path.exists(path):
                os.remove(path)
            write_h5features(path, "features", data.items(), data.labels(),
                             embs)
