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

``transfer_dtype`` picks the wire codec of the device-to-host copies
(:func:`encode_transfer` on the device, :func:`decode_transfer` on the
host): the files always store float32. ``streaming=True`` reads the
input file item by item and appends each file's embeddings as soon as
its last chunk is back, so memory stays bounded by the chunks in flight
and one file, whatever the corpus size.

``MultimodalEmbedder`` feeds one chunk of every modality to the
multimodal network's forward (each modality cut at the same frame
boundaries) and writes the embeddings and, for a learnt attention unit,
the attention weights.

With a ``mesh`` (one process per GPU, :func:`abnet3_torch.parallel
.make_mesh`, or a YAML dict) every rank cuts the same chunks, rounded to
the 'data' axis, and runs its block of each chunk's rows (the towers
sharded over 'model' when that axis is larger than 1); the codecs take
their int8/int4 scalars over the whole chunk (min and max all-reduced
over 'data'), the codes are gathered, and rank 0 writes the files: the
embeddings equal world size 1's.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from abnet3_torch import dist as mesh_dist
from abnet3_torch.profiling import span, stage_trace
from abnet3_torch.utils import EmbeddingObserver, resolve_device

__all__ = ["EmbedderBuilder", "EmbedderSiamese", "EmbedderSiameseMultitask",
           "MultimodalEmbedder", "encode_transfer", "decode_transfer"]

_WINDOW = 16       # encoded chunks in flight on the device before a drain
_FLUSH_EVERY = 32  # finished files a streaming writer appends at once


def _global_extreme(t: torch.Tensor, op, group) -> torch.Tensor:
    if group is not None:
        t = t.clone()
        dist.all_reduce(t, op=op, group=group)
    return t


def encode_transfer(out: torch.Tensor, transfer_dtype: str, group=None):
    """Device-side wire codec: shrink the bytes a chunk of embeddings
    ships over the device->host copy (the files always store float32; the
    codec lives on the wire only). Takes and returns tensors on ``out``'s
    device, as a tuple of leaves, in float32 arithmetic in the JAX
    package's order, so the same float32 input gives the same codes:

    - ``float32``: identity, 4 B/value.
    - ``bfloat16``: cast, 2 B/value, ~3 decimal digits.
    - ``int8``: one affine scale for the chunk, ``q = round((x-lo)/scale)``
      (half to even) with the scalar ``lo``/``scale`` riding along,
      1 B/value; the round-trip error is at most (hi-lo)/510.
    - ``int4``: one affine scale per dimension, two codes packed in a
      uint8 (an odd dimension count pads one zero column on the wire),
      0.5 B/value plus 8 B a dimension; the error is at most
      (hi_d-lo_d)/30 in dimension d. Opt-in: too coarse for numeric
      reuse, fine for ABX ranking.

    ``group``: ``out`` is one rank's block of the chunk's rows; the min
    and max are taken over the group (the whole chunk), so the codes
    equal an unsharded encode's.
    """
    MIN, MAX = dist.ReduceOp.MIN, dist.ReduceOp.MAX
    if transfer_dtype == "bfloat16":
        return (out.to(torch.bfloat16),)
    # the divisors are tensors on out's device: on the card, a Python
    # scalar divisor becomes a multiply by its reciprocal, which rounds
    # otherwise than the division of the CPU and of the JAX package
    if transfer_dtype == "int8":
        lo = _global_extreme(torch.min(out), MIN, group)
        hi = _global_extreme(torch.max(out), MAX, group)
        scale = (torch.clamp(hi - lo, min=1e-12)
                 / torch.full_like(lo, 255.0))
        q = torch.round((out - lo) / scale).to(torch.uint8)
        return (q, lo.float(), scale.float())
    if transfer_dtype == "int4":
        lo = _global_extreme(torch.amin(out, dim=0), MIN, group)
        hi = _global_extreme(torch.amax(out, dim=0), MAX, group)
        scale = (torch.clamp(hi - lo, min=1e-12)
                 / torch.full_like(lo, 15.0))
        q = torch.round((out - lo) / scale).to(torch.uint8)
        if q.shape[1] % 2:
            q = torch.nn.functional.pad(q, (0, 1))
        packed = q[:, 0::2] | (q[:, 1::2] << 4)
        return (packed, lo.float(), scale.float())
    return (out,)


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array: a tensor is copied to the host first
    and only then upcast from bfloat16 (numpy has no bfloat16), so the
    wire carries the codec's bytes."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.numpy()
    return np.asarray(leaf)


def decode_transfer(leaves) -> np.ndarray:
    """Host-side inverse of :func:`encode_transfer` -> float32 array; the
    leaves are tensors (on any device) or numpy arrays."""
    if len(leaves) == 1:
        host = _host(leaves[0])
        return host if host.dtype == np.float32 \
            else host.astype(np.float32)
    q, lo, scale = (_host(p) for p in leaves)
    if lo.ndim == 1:  # int4: per-dim affine, two codes per uint8
        d = lo.shape[0]
        un = np.empty((q.shape[0], 2 * q.shape[1]), np.float32)
        un[:, 0::2] = q & 0x0F
        un[:, 1::2] = q >> 4
        return un[:, :d] * scale[None, :] + lo[None, :]
    return q.astype(np.float32) * float(scale) + float(lo)


def _decode_rows(head, valid: int) -> np.ndarray:
    """The first ``valid`` rows of one encoded head, decoded on the host:
    only the codes of those rows cross the wire."""
    return decode_transfer((head[0][:valid],) + tuple(head[1:]))


class EmbedderBuilder:
    """Generic embedder (reference embedder.py:19-50). The forward runs on
    the card unless ``cuda=False`` or ``device="cpu"``; the network must
    live on that device. ``mesh``: see the module."""

    def __init__(self, network=None, network_path=None, feature_path=None,
                 output_path=None, cuda=True, batch_size=5000, mesh=None,
                 transfer_dtype="float32", streaming=False, device=None):
        if network is None:
            raise ValueError("network is None.")
        assert transfer_dtype in ("float32", "bfloat16", "int8", "int4")
        self.network = network
        self.network_path = network_path
        self.feature_path = feature_path
        self.output_path = output_path
        self.cuda = cuda
        self.device = resolve_device(device, cuda)
        if isinstance(mesh, dict):
            from abnet3_torch.parallel import make_mesh
            mesh = make_mesh(n_data=mesh.get("data"),
                             n_model=mesh.get("model", 1),
                             device=self.device)
        self.mesh = mesh
        self.transfer_dtype = transfer_dtype
        self.streaming = streaming
        self._n_data = 1
        self._data_group = None
        if mesh is not None:
            from abnet3_torch.parallel import mesh_shape
            self._n_data = n_data = mesh_shape(mesh)["data"]
            if n_data > 1:
                self._data_group = mesh.get_group("data")
            # chunk rows divide evenly over the data axis
            batch_size = ((batch_size + n_data - 1) // n_data) * n_data
        self.batch_size = batch_size

    def _load(self):
        if self.network_path is not None:
            self.network.load_network(self.network_path)
        else:
            self.network.ensure_init()
        if self.network.device != self.device:
            raise ValueError(f"the network lives on {self.network.device}, "
                             f"the embedder runs on {self.device}")
        self._shard_network()
        print("Done loading network weights")

    def _shard_network(self):
        """Shard the towers over the mesh's 'model' axis, once."""
        if self.mesh is not None and getattr(self.network, "_mesh",
                                             None) is None:
            from abnet3_torch.parallel import shard_network
            shard_network(self.network, self.mesh)

    def _rank_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of a chunk's rows (the chunk itself without
        a mesh)."""
        if self._data_group is None:
            return x
        from abnet3_torch.parallel import shard_array
        return shard_array(x, self.mesh, ("data",))

    def _encode(self, out: torch.Tensor):
        """:func:`encode_transfer` of one head; on a mesh over the whole
        chunk (global scalars, the ranks' codes gathered in row order)."""
        leaves = encode_transfer(out, self.transfer_dtype,
                                 group=self._data_group)
        if self._data_group is None:
            return leaves
        return (mesh_dist.all_gather_rows(leaves[0], self._data_group,
                                          self._n_data),) + tuple(leaves[1:])

    def _forward_fn(self):
        """(rows, d) float32 tensor on the network's device -> a tuple of
        heads (one, or the multitask network's speaker and phone heads),
        each the tuple of :func:`encode_transfer` leaves of its (rows,
        d_out) embeddings; one branch in eval mode (the network's mode is
        restored after each call)."""
        network = self.network
        self._shard_network()

        @torch.no_grad()
        def forward(x):
            was_training = network.training
            network.eval()
            try:
                out = network.forward_once(self._rank_rows(x))
            finally:
                network.train(was_training)
            heads = tuple(out) if isinstance(out, (tuple, list)) else (out,)
            return tuple(self._encode(h) for h in heads)

        return forward

    def _pad_target(self, n: int) -> int:
        """Padded row count for a tail chunk: the smallest rung of a /4
        ladder under batch_size (floored at 256 rows, rounded up to the
        mesh's 'data' axis) that holds ``n``; full chunks stay at
        batch_size. A short tail does not pay for a full chunk of padding,
        and the chunk shapes stay few."""
        n_data = self._n_data
        floor = max(256, n_data)
        sizes = [self.batch_size]
        while sizes[-1] // 4 >= floor:
            sizes.append(-(-(sizes[-1] // 4) // n_data) * n_data)
        for s in sorted(sizes):
            if n <= s:
                return s
        return self.batch_size

    def _embed_corpus(self, forward, feats_list, n_outputs: int = 1):
        """Embed every file's frames: :meth:`_embed_streaming` over the
        list, so both paths cut the same chunks by construction. Returns
        one float32 (n_frames_i, d_out) array per file; with ``n_outputs``
        > 1 a tuple of one such list per head."""
        done = []
        self._embed_streaming(
            forward, ((i, None, f) for i, f in enumerate(feats_list)),
            lambda item, labels, embs: done.append(embs), n_outputs)
        lists = [[embs[h] for embs in done] for h in range(n_outputs)]
        return lists[0] if n_outputs == 1 else tuple(lists)

    def _embed_array(self, forward, feat: np.ndarray) -> np.ndarray:
        """Embed one file (kept for API compatibility); see
        :meth:`_embed_corpus`."""
        return self._embed_corpus(forward, [feat])[0]

    def _embed_streaming(self, forward, stream, on_file_done,
                         n_outputs: int = 1):
        """Embed a stream of files through fixed-size padded chunks.

        ``stream`` yields ``(item, labels, frames)``, ``frames`` one array
        or a tuple of one array per modality (equal frame counts: every
        modality is cut at the same rows, and ``forward`` takes one chunk
        per modality); each file's decoded
        embeddings go to ``on_file_done(item, labels, [per-head arrays])``
        as soon as its last chunk drains. PACKED: the files' frames form
        one stream and chunks are cut from it across file boundaries
        (every forward is row-independent in eval mode); a chunk records
        its (file, rows) spans and splits on drain. The tail chunk pads to
        the :meth:`_pad_target` ladder by repeating its last valid row
        (pad rows are dropped, but their outputs enter the int8 codec's
        per-chunk min and max: zero rows would widen its range). Up to
        ``_WINDOW`` chunks are in flight on the device before the oldest
        is copied back and decoded, so the host cuts the next chunk while
        the card runs; memory is O(window + current file). ``forward``
        returns one encoded head per output (:meth:`_forward_fn`).
        ``on_file_done`` fires strictly in stream order (h5features
        appends positionally), 0-frame files included, which emit (0, d)
        arrays: one that precedes every forward waits for the first drain
        to learn d, and a stream of only empty files runs one probe
        forward (a (0, 0) feature set writes a malformed h5features
        container)."""
        bs = self.batch_size
        device = self.network.device
        pending = []   # (spans, valid_rows, encoded heads)
        live = {}      # file_seq -> [item, labels, [parts]*heads, n_left]
        buf = []       # [(file_seq, per-modality rows)] not dispatched
        buf_rows = 0
        head_dims = [None] * n_outputs
        in_dims = None  # feature dims, for the all-empty-stream probe

        def emit_ready():
            # emit completed files from the front of `live` (insertion =
            # stream order): a later file never finishes a drain before
            # an earlier one, so this keeps the corpus order exactly
            while live:
                seq = next(iter(live))
                item, labels, parts, n_left = live[seq]
                if n_left != 0:
                    return
                if parts[0]:
                    out = [p[0] if len(p) == 1 else np.vstack(p)
                           for p in parts]
                elif head_dims[0] is not None:
                    out = [np.zeros((0, head_dims[h]), np.float32)
                           for h in range(n_outputs)]
                else:  # 0-frame file before any forward: dims unknown
                    return
                del live[seq]
                on_file_done(item, labels, out)

        def drain_one():
            with span("embed.drain"):
                spans, valid, heads = pending.pop(0)
                decs = [_decode_rows(head, valid) for head in heads]
                for h, d in enumerate(decs):
                    head_dims[h] = d.shape[1]
                r = 0
                for seq, k in spans:
                    rec = live[seq]
                    for h in range(n_outputs):
                        rec[2][h].append(decs[h][r:r + k])
                    rec[3] -= k
                    r += k
            emit_ready()

        def dispatch(valid):
            nonlocal buf_rows
            with span("embed.dispatch"):
                spans, pieces, got = [], [], 0
                while got < valid:
                    seq, mods = buf[0]
                    n = len(mods[0])
                    take = min(n, valid - got)
                    spans.append((seq, take))
                    pieces.append([m[:take] for m in mods])
                    if take == n:
                        buf.pop(0)
                    else:
                        buf[0] = (seq, tuple(m[take:] for m in mods))
                    got += take
                buf_rows -= valid
                target = bs if valid == bs else self._pad_target(valid)
                xs = []
                for k in range(len(pieces[0])):
                    chunk = (pieces[0][k] if len(pieces) == 1
                             else np.vstack([p[k] for p in pieces]))
                    if target > valid:
                        chunk = np.vstack([chunk, np.repeat(
                            chunk[-1:], target - valid, axis=0)])
                    xs.append(torch.from_numpy(
                        np.ascontiguousarray(chunk)).to(device))
                pending.append((spans, valid, forward(*xs)))
                if len(pending) >= _WINDOW:
                    drain_one()

        with span("embed.export"):
            for seq, (item, labels, feat) in enumerate(stream):
                mods = tuple(np.asarray(m, np.float32) for m in (
                    feat if isinstance(feat, tuple) else (feat,)))
                n = len(mods[0])
                if any(len(m) != n for m in mods):
                    raise ValueError(f"{item}: the modalities have "
                                     f"{[len(m) for m in mods]} frames; they "
                                     "must have the same frame count")
                if all(m.ndim == 2 for m in mods):
                    in_dims = [m.shape[1] for m in mods]
                live[seq] = [item, labels, [[] for _ in range(n_outputs)], n]
                if n == 0:
                    emit_ready()
                    continue
                buf.append((seq, mods))
                buf_rows += n
                while buf_rows >= bs:
                    dispatch(bs)
            if buf_rows:
                dispatch(buf_rows)
            while pending:
                drain_one()
            if live:
                # only 0-frame files can remain: the stream never ran a
                # forward (all files empty), so probe one ladder-rung zero
                # chunk for the head dims
                if head_dims[0] is None and in_dims is not None:
                    heads = forward(*(torch.zeros(
                        (self._pad_target(1), d), dtype=torch.float32,
                        device=device) for d in in_dims))
                    for h, head in enumerate(heads):
                        head_dims[h] = decode_transfer(head).shape[1]
                if head_dims[0] is None:
                    head_dims = [0] * n_outputs
                emit_ready()
            assert not live

    def _embed_file(self, forward, suffixes):
        """Embed ``feature_path`` into one h5features file a head
        (``output_path`` + each of ``suffixes``), replacing any file
        already there: the whole corpus at once, or streamed item by item
        with ``streaming=True``. On a mesh rank 0 writes; every rank
        returns once the files are there."""
        from abnet3_torch.io.h5f import (iter_h5features, read_h5features,
                                         write_h5features)
        paths = [self.output_path + suffix for suffix in suffixes]
        writes = mesh_dist.is_writer()
        if self.streaming:
            writers = []
            if writes:
                for path in paths:
                    if os.path.exists(path):
                        os.remove(path)
                writers = [_BatchedWriter(path, "features")
                           for path in paths]

            def on_done(item, labels, embs):
                for writer, e in zip(writers, embs):
                    writer.add(item, labels, e)

            with stage_trace("embed"):
                self._embed_streaming(
                    forward, iter_h5features(self.feature_path, "features"),
                    on_done, n_outputs=len(paths))
            for writer in writers:
                writer.flush()
            mesh_dist.barrier()
            return
        data = read_h5features(self.feature_path, "features")
        print("Done loading input feature file")
        with stage_trace("embed"):
            heads = self._embed_corpus(forward, data.features(),
                                       n_outputs=len(paths))
        if len(paths) == 1:
            heads = (heads,)
        for path, embs in zip(paths, heads if writes else ()):
            if os.path.exists(path):
                os.remove(path)
            write_h5features(path, "features", data.items(), data.labels(),
                             embs)
        mesh_dist.barrier()

    def embed(self):
        raise NotImplementedError("Unimplemented embed for class:",
                                  self.__class__.__name__)


class EmbedderSiamese(EmbedderBuilder):
    """Monotask embedding export (reference embedder.py:53-100): reads
    ``feature_path`` and writes ``output_path``, both h5features."""

    def embed(self):
        self._load()
        self._embed_file(self._forward_fn(), ("",))


class EmbedderSiameseMultitask(EmbedderBuilder):
    """Multitask embedding export (reference embedder.py:103-149): reads
    ``feature_path`` and writes the speaker head's embeddings to
    ``output_path + ".spk"`` and the phone head's to ``output_path +
    ".phn"``, both h5features."""

    def embed(self):
        self._load()
        self._embed_file(self._forward_fn(), (".spk", ".phn"))


class MultimodalEmbedder(EmbedderBuilder):
    """Multimodal embedding export (reference embedder.py:151-221):
    ``feature_path`` is one h5features file per modality, joined by item
    name; writes ``output_path + "embedded.features"`` and, when the unit
    is a ``BiWeightedDeepLearnt`` (an observer is placed), the attention
    weights to ``output_path + "attention_weights.features"``, (frames, 1)
    a file. The forward returns the weights with the embeddings; a unit
    frozen to its headstart scalar gives that scalar on every frame.
    ``transfer_dtype`` applies to both. :meth:`embed_modalities` embeds
    in-memory per-modality lists."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.observers = []
        from abnet3_torch.integration import BiWeightedDeepLearnt
        if isinstance(getattr(self.network, "integration_unit", None),
                      BiWeightedDeepLearnt):
            print("Placing observer to save learnt attention weights")
            self.observers.append(EmbeddingObserver(
                self.network.integration_unit.get_weights,
                self.output_path + "attention_weights.features"))

    def _forward_fn(self):
        """One chunk per modality -> (embeddings[, attention weights]),
        each encoded by :func:`encode_transfer`."""
        network = self.network
        unit = network.integration_unit
        want_attention = bool(self.observers)
        self._shard_network()

        @torch.no_grad()
        def forward(*xs):
            xs = [self._rank_rows(x) for x in xs]
            was_training = network.training
            network.eval()
            try:
                if want_attention:
                    unit._last_weight = None
                emb = network.forward_once(xs)
            finally:
                network.train(was_training)
            heads = [self._encode(emb)]
            if want_attention:
                # None: the unit is frozen to a scalar (headstart)
                w = unit._last_weight
                if w is None:
                    w = torch.full((xs[0].shape[0], 1),
                                   float(unit.get_weights()),
                                   device=emb.device)
                heads.append(self._encode(w))
            return tuple(heads)

        return forward

    def embed_modalities(self, modalities):
        """Embed in-memory features: ``modalities`` holds, per modality,
        one (frames, d_m) array per file, the files in the same order.
        Returns (embeddings per file, attention weights per file or
        None)."""
        feats_list = [tuple(col[i] for col in modalities)
                      for i in range(len(modalities[0]))]
        if self.observers:
            embs, weights = self._embed_corpus(self._forward_fn(),
                                               feats_list, n_outputs=2)
            return embs, weights
        return self._embed_corpus(self._forward_fn(), feats_list), None

    def embed(self):
        from abnet3_torch.io.h5f import read_h5features, write_h5features
        self._load()
        if self.streaming:
            print("WARNING: streaming=True is not supported by "
                  "MultimodalEmbedder (modalities must be joined per "
                  "item); loading the full corpora instead")
        datasets = [read_h5features(p, "features")
                    for p in self.feature_path]
        items = datasets[0].items()
        times = datasets[0].labels()
        print("Done loading input feature file")
        # join the modalities by item name, not by file position
        cols = [datasets[0].features()]
        for p, d in zip(self.feature_path[1:], datasets[1:]):
            idx = {it: i for i, it in enumerate(d.items())}
            absent = [it for it in items if it not in idx]
            if absent:
                raise KeyError("items in %s missing from modality file "
                               "%s: %s" % (self.feature_path[0], p,
                                           absent[:5]))
            fs = d.features()
            cols.append([fs[idx[it]] for it in items])
        with stage_trace("embed"):
            embeddings, weights = self.embed_modalities(cols)
        if mesh_dist.is_writer():
            path = self.output_path + "embedded.features"
            if os.path.exists(path):
                os.remove(path)
            write_h5features(path, "features", items, times, embeddings)
            if weights is not None:
                for observer in self.observers:
                    observer.record_arrays(weights)
                    observer.save(items, times)
        mesh_dist.barrier()


class _BatchedWriter:
    """Collect finished files and append them to an h5features file in
    batches of ``_FLUSH_EVERY`` (one reopen a flush, not a file: the
    writer appends to an existing file)."""

    def __init__(self, path: str, group: str):
        self.path = path
        self.group = group
        self._items = []
        self._labels = []
        self._feats = []

    def add(self, item, labels, feats):
        self._items.append(item)
        self._labels.append(labels)
        self._feats.append(feats)
        if len(self._items) >= _FLUSH_EVERY:
            self.flush()

    def flush(self):
        from abnet3_torch.io.h5f import write_h5features
        if self._items:
            write_h5features(self.path, self.group, self._items,
                             self._labels, self._feats)
            self._items, self._labels, self._feats = [], [], []
