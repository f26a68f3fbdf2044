"""ABX discriminability evaluation, with the token distances on the card.

The counterpart of ``abnet3_tpu/eval/abx.py``. Tokens live in a
device-resident :class:`~abnet3_torch.ops.bank.TokenBank`; the O(N^2)
normalized DTW distances run on the card (a matmul for the frame
distances, then the hand-written DTW path-stats kernel). The (N, N)
distance matrix either returns to the host for the numpy scorer
(:func:`abx_error`) or stays on the card for the device scorer
(:mod:`abnet3_torch.eval.abx_device`, ``distance_matrix(device_out=True)``).

Distances
---------
- ``dtw_cos`` (default): mean angular cosine frame distance along the
  optimal DTW path (ABXpy's dtw_cosine).
- ``dtw_kl``: mean symmetrised KL divergence along the DTW path (ABXpy's
  dtw_kl, for posteriorgrams; tiles stay float32 since KL is unbounded).
- ``mean_cos``: angular cosine distance of masked mean-pooled tokens.

Score
-----
error = mean of ``1[d(A,B) > d(A,X)] + 0.5 * 1[d(A,B) == d(A,X)]``, with
``task='across'`` (B shares A's class, not its speaker; X shares A's
speaker, not its class; cells (class_A, class_X)) or ``task='within'``
(one speaker; cells (class_A, class_X, speaker)); optional ABXpy-style
BY-conditioning. Triplet errors average triplets -> cell -> mean over
non-empty cells.

Every DTW distance on the card takes the CUDA kernel and every one on the
CPU its plain version; the matmuls run in full float32 whatever the
global TF32 setting (:func:`full_float32`). On the card without a mesh
split, a DTW tile's anchor rows replay one CUDA graph each
(:class:`_TileRows`): the same kernels on the same shapes as the eager
row loop, so the same distances bit for bit.

With a ``mesh`` (one process per GPU) the pair batches and the tile rows
are split over the mesh's 'data' axis: each rank runs the stats kernel on
its block and the blocks are gathered, so every rank holds the whole
matrix (equal to world size 1's: each pair's DTW does not depend on the
layout); rank 0 alone writes a checkpoint, and the device matrix is
row-sharded (:func:`abnet3_torch.eval.abx_device.upload_matrix`).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from abnet3_torch.eval import abx_device
from abnet3_torch.ops.cuda_dtw import LAUNCHERS
from abnet3_torch.ops.dtw import (anchor_angular_distance_rows,
                                  anchor_kl_distance_rows, dtw_path_stats,
                                  dtw_path_stats_rows,
                                  pairwise_angular_distance,
                                  pairwise_kl_distance, unit_frames)
from abnet3_torch.profiling import count, span
from abnet3_torch.utils import full_float32

__all__ = ["make_pair_distance_fn", "distance_matrix", "abx_error",
           "read_item_file", "evaluate", "main", "full_float32"]


def _n_data(mesh) -> int:
    if mesh is None:
        return 1
    return int(mesh.size(mesh.mesh_dim_names.index("data")))


def _rows_on_mesh(mesh, rows: int, compute):
    """``compute(start, stop)`` of this rank's block of ``rows`` rows
    (a multiple of the 'data' axis), gathered in row order: the whole
    (rows, ...) result on every rank; ``compute(0, rows)`` without a
    mesh."""
    n = _n_data(mesh)
    if n == 1:
        return compute(0, rows)
    from abnet3_torch.dist import all_gather_rows, block
    rank = mesh.get_local_rank("data")
    return all_gather_rows(compute(*block(rows, n, rank)),
                           mesh.get_group("data"), n)


def _masked_mean_pool(f: torch.Tensor, n: torch.Tensor, T: int
                      ) -> torch.Tensor:
    """Mean over each token's valid frames: f (B, T, d) zero-padded,
    n (B,) true lengths -> (B, d). Both distance strategies pool with
    this one definition, so mean_cos agrees across them."""
    m = (torch.arange(T, device=f.device)[None, :] < n[:, None])[..., None]
    return torch.sum(f * m, 1) / torch.clamp(n[:, None], min=1).to(f.dtype)


def _frames(bank, max_frames: Optional[int]) -> int:
    """The time axis ``bank.take`` returns for ``max_frames``."""
    return (min(max_frames, bank.max_len) if max_frames is not None
            else bank.max_len)


def _ids(ids: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(ids, np.int64)).to(device)


def make_pair_distance_fn(bank, distance: str = "dtw_cos",
                          max_frames: Optional[int] = None, mesh=None):
    """(ids1, ids2) -> (B,) normalized token distances over a TokenBank,
    ids as (B,) tensors on the bank's device. With a ``mesh`` each rank
    computes its block of the pairs (padded to the 'data' axis) and the
    distances are gathered."""
    assert distance in ("dtw_cos", "dtw_kl", "mean_cos")
    T = _frames(bank, max_frames)
    n_data = _n_data(mesh)

    def fn(ids1: torch.Tensor, ids2: torch.Tensor) -> torch.Tensor:
        if n_data == 1:
            return local(ids1, ids2)
        B = ids1.shape[0]
        pad = (-B) % n_data
        if pad:
            zero = ids1.new_zeros(pad)
            ids1, ids2 = torch.cat([ids1, zero]), torch.cat([ids2, zero])
        return _rows_on_mesh(mesh, B + pad, lambda a, b: local(
            ids1[a:b], ids2[a:b]))[:B]

    def local(ids1: torch.Tensor, ids2: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), full_float32():
            f1, n1 = bank.take(ids1, T)
            f2, n2 = bank.take(ids2, T)
            if distance == "mean_cos":
                v1 = _masked_mean_pool(f1, n1, T)
                v2 = _masked_mean_pool(f2, n2, T)
                return pairwise_angular_distance(
                    v1[:, None, :], v2[:, None, :])[:, 0, 0]
            frame_dist = (pairwise_kl_distance if distance == "dtw_kl"
                          else pairwise_angular_distance)
            # mean distance along the optimal path: the path sum is the DP
            # endpoint cost, the length rides the argmin chain
            psum, plen = dtw_path_stats(frame_dist(f1, f2), n1, n2)
            return psum / torch.clamp(plen, min=1.0)

    return fn


def _pooled_token_vectors(bank, max_frames=None, chunk: int = 2048
                          ) -> torch.Tensor:
    """Masked mean-pooled token vectors (N, d) on the bank's device,
    computed in id chunks (the padded (chunk, T, d) gather stays small)."""
    T = _frames(bank, max_frames)
    N = len(bank)
    device = bank.bank.device
    out = []
    for c0 in range(0, N, chunk):
        f, n = bank.take(_ids(np.arange(c0, min(c0 + chunk, N)), device), T)
        out.append(_masked_mean_pool(f, n, T))
    return torch.cat(out, 0)


def _auto_block(N: int, T: int, batch_size: int, n_data: int = 1,
                itemsize: int = 2, fetch_capped: bool = True) -> int:
    """Tokens per tile side, the JAX package's rule unchanged (so the
    tile layouts, and with them the matrices, match): at most
    ``batch_size``, a (block, T, T) distance transient of at most 2^26
    values, about N/4 (with t tiles per side the upper-triangle tiling
    computes t(t+1)/2 * block^2 pairs for N^2/2 needed), and a tile of at
    most 2 MB of ``itemsize``-byte values."""
    cap = max(8, int((1 << 26) / max(T * T, 1)))
    quarter = max(64, -(-N // 4))
    caps = [N, batch_size, cap, quarter]
    if fetch_capped:
        caps.append(max(64, int(((2 << 20) // itemsize) ** 0.5)))
    block = max(1, min(caps))
    if n_data > 1:
        block = max(n_data, (block // n_data) * n_data)
    return block


# uint16 fixed-point tile codec: angular distances live in [0, 1], so a
# tile leaves the card as round(d * 65535) (max error 1/(2*65535), about
# 7.6e-6) and the host matrix dequantizes to out_dtype, exactly as the JAX
# package's tiles do. torch.round rounds half to even, like jnp.round.
_U16_SCALE = 65535.0


def _encode_tile_u16(d: torch.Tensor) -> torch.Tensor:
    """u16 codes, held in int32 (the card's uint16 support is partial)."""
    return torch.round(torch.clamp(d, 0.0, 1.0) * _U16_SCALE).to(torch.int32)


def _decode_tile_u16(q: np.ndarray, out_dtype) -> np.ndarray:
    return (np.asarray(q).astype(np.float32)
            * np.float32(1.0 / _U16_SCALE)).astype(out_dtype)


def _pairs_distance_matrix(bank, distance, batch_size, max_frames,
                           out_dtype, mesh=None) -> np.ndarray:
    """Flat pair-stream strategy: fixed-size (ids1, ids2) batches of the
    upper triangle (tail padded with pair (0, 0), discarded), a window of
    batches in flight on the card before the oldest is copied back."""
    N = len(bank)
    device = bank.bank.device
    fn = make_pair_distance_fn(bank, distance=distance,
                               max_frames=max_frames, mesh=mesh)
    iu = np.triu_indices(N, k=1)
    ids1_all = iu[0].astype(np.int64)
    ids2_all = iu[1].astype(np.int64)
    D = np.zeros((N, N), out_dtype)
    total = len(ids1_all)
    pending: List[Tuple[int, int, torch.Tensor]] = []
    window = 8

    def drain_one():
        c, nv, o = pending.pop(0)
        vals = o[:nv].cpu().numpy().astype(out_dtype)
        D[ids1_all[c:c + nv], ids2_all[c:c + nv]] = vals
        D[ids2_all[c:c + nv], ids1_all[c:c + nv]] = vals

    for c0 in range(0, total, batch_size):
        i1 = ids1_all[c0:c0 + batch_size]
        i2 = ids2_all[c0:c0 + batch_size]
        n_valid = len(i1)
        if n_valid < batch_size:
            pad = batch_size - n_valid
            i1 = np.concatenate([i1, np.zeros(pad, np.int64)])
            i2 = np.concatenate([i2, np.zeros(pad, np.int64)])
        pending.append((c0, n_valid, fn(_ids(i1, device), _ids(i2, device))))
        if len(pending) >= window:
            drain_one()
    while pending:
        drain_one()
    return D


# below this many tokens ``strategy='auto'`` takes the pair stream
_TILE_MIN_TOKENS = 2048


def _anchor_row(fi: torch.Tensor, n1: torch.Tensor, cols, nj: torch.Tensor,
                kl: bool, out: torch.Tensor) -> None:
    """One anchor's distances to a tile's column tokens into ``out``
    (block,): the anchor-form distance rows (Tc, block, Tc) from one
    matmul, then ONE stats-kernel launch on them, read in place. ``fi``
    (Tc, d) is the anchor's frames, ``n1`` (block,) its length, ``cols``
    the columns' frames (dtw_kl) or their :func:`unit_frames` (dtw_cos),
    ``nj`` their lengths."""
    rows = (anchor_kl_distance_rows(fi, cols) if kl
            else anchor_angular_distance_rows(fi, None, y_unit=cols))
    psum, plen = dtw_path_stats_rows(rows, n1, nj)
    torch.div(psum, torch.clamp(plen, min=1.0), out=out)


def _rows_graphed(device: torch.device, n_rows: int, block: int) -> bool:
    """Whether a DTW tile's anchor rows replay a CUDA graph
    (:class:`_TileRows`): on the card, where one process computes every
    row of the tile (a mesh's 'data' split stays eager)."""
    return device.type == "cuda" and n_rows == block


class _TileRows:
    """A DTW tile's anchor rows as one body on static device buffers.

    :meth:`load` puts a tile's anchors (frames, lengths) and columns
    (dtw_kl: frames; dtw_cos: unit frames and zero mask; lengths) into
    the buffers and sets the row counter ``r`` (a device scalar) to 0;
    each :meth:`body` then scores anchor ``r`` with :func:`_anchor_row`,
    writes it to ``out[r]`` and advances ``r``. No input comes from the
    host, so on the card :meth:`run` captures the body once as a CUDA
    graph and replays it for every anchor: the first row of the first
    tile is the body's eager warm-up on the capture's side stream, the
    capture is ``thread_local`` (as the train steps' graphs,
    :class:`abnet3_torch.parallel.mesh._GraphedSteps`). A replay adds
    the kernel launches that the capture held to the wrappers' counts."""

    def __init__(self, distance: str, Tc: int, block: int, dim: int,
                 device):
        self.kl = distance == "dtw_kl"
        self.block = block
        f32 = dict(dtype=torch.float32, device=device)
        self.anchors = torch.empty((block, Tc, dim), **f32)
        self.n1 = torch.empty(block, dtype=torch.int32, device=device)
        self.cols = (torch.empty((block, Tc, dim), **f32) if self.kl else
                     (torch.empty((block, Tc, dim), dtype=torch.float64,
                                  device=device),
                      torch.empty((block, Tc), dtype=torch.bool,
                                  device=device)))
        self.nj = torch.empty(block, dtype=torch.int32, device=device)
        self.r = torch.zeros(1, dtype=torch.int64, device=device)
        self.row = torch.empty(block, **f32)
        self.out = torch.empty((block, block), **f32)
        self.stream = self.graph = None
        self.launches: List[int] = []

    def load(self, bank, ids_i: np.ndarray, ids_j: np.ndarray) -> None:
        device, Tc = self.out.device, self.anchors.shape[1]
        fi, n1 = bank.take(_ids(ids_i, device), Tc)
        fj, nj = bank.take(_ids(ids_j, device), Tc)
        self.anchors.copy_(fi)
        self.n1.copy_(n1)
        self.nj.copy_(nj)
        if self.kl:
            self.cols.copy_(fj)
        else:
            for buf, v in zip(self.cols, unit_frames(fj)):
                buf.copy_(v)
        self.r.zero_()

    def body(self) -> None:
        r = self.r
        _anchor_row(self.anchors.index_select(0, r)[0],
                    self.n1.index_select(0, r).expand(self.block),
                    self.cols, self.nj, self.kl, self.row)
        self.out.index_copy_(0, r, self.row[None])
        r.add_(1)

    def run(self, bank, ids_i: np.ndarray, ids_j: np.ndarray
            ) -> torch.Tensor:
        """The tile's (block, block) distances, one replay a row."""
        self.load(bank, ids_i, ids_j)
        for r in range(self.block):
            if self.stream is not None and self.graph is None:
                self._capture()
            with span("abx.row", r):
                if self.stream is None:
                    self._warm_up()
                else:
                    self.graph.replay()
                    count("abx/row_replays", 1)
                    for f, n in zip(LAUNCHERS, self.launches):
                        f.launches += n
        return self.out.clone()

    def _warm_up(self) -> None:
        main = torch.cuda.current_stream(self.out.device)
        self.stream = torch.cuda.Stream(self.out.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            self.body()
        main.wait_stream(self.stream)

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        before = [f.launches for f in LAUNCHERS]
        with torch.cuda.graph(graph, stream=self.stream,
                              capture_error_mode="thread_local"):
            self.body()
        # the capture launched nothing; each replay counts its launches
        self.launches = [f.launches - n for f, n in zip(LAUNCHERS, before)]
        for f, n in zip(LAUNCHERS, before):
            f.launches = n
        self.graph = graph


# the tile rows of the last (device, distance, Tc, block, d) graphed:
# distance_matrix runs once an evaluation on a new bank, and the graph,
# which reads only its own buffers, outlives the call, so later
# evaluations of the same shapes replay without a capture; one key at a
# time bounds the card memory that the buffers and the graph's pool hold
# (and, the buffers being shared, one distance_matrix runs at a time)
_GRAPHED_ROWS: Dict[tuple, _TileRows] = {}


def _graphed_rows(distance: str, Tc: int, block: int, dim: int,
                  device) -> _TileRows:
    key = (device, distance, Tc, block, dim)
    if key not in _GRAPHED_ROWS:
        _GRAPHED_ROWS.clear()
        _GRAPHED_ROWS[key] = _TileRows(distance, Tc, block, dim, device)
    return _GRAPHED_ROWS[key]


def _dtw_tile_fn(bank, distance: str, T: int, block: int,
                 n_rows: Optional[int] = None):
    """(ids_i, ids_j) host id arrays of one tile -> its (block, block)
    float32 distances on the card, or with ``n_rows`` the (n_rows, block)
    distances of ``n_rows`` anchors (one rank's rows on a mesh). Each row
    scores one anchor against the tile's column tokens
    (:func:`_anchor_row`); where :func:`_rows_graphed` holds, each row is
    a replay of :class:`_TileRows`' graph."""
    device = bank.bank.device
    Tc = _frames(bank, T)
    kl = distance == "dtw_kl"
    n_rows = block if n_rows is None else n_rows
    if _rows_graphed(device, n_rows, block):
        rows = _graphed_rows(distance, Tc, block, bank.dim, device)

        def graphed(ids_i: np.ndarray, ids_j: np.ndarray) -> torch.Tensor:
            with torch.cuda.device(device):
                return rows.run(bank, ids_i, ids_j)
        return graphed
    n1 = torch.empty(block, dtype=torch.int32, device=device)

    def tile(ids_i: np.ndarray, ids_j: np.ndarray) -> torch.Tensor:
        fj, nj = bank.take(_ids(ids_j, device), T)
        nj = nj.to(torch.int32).contiguous()
        cols = fj if kl else unit_frames(fj)
        out = torch.empty((n_rows, block), dtype=torch.float32,
                          device=device)
        for r, i in enumerate(ids_i.tolist()):
            with span("abx.row", r):
                n1.fill_(min(int(bank.lengths_host[i]), Tc))
                _anchor_row(bank.bank[i, :Tc], n1, cols, nj, kl, out[r])
        return out

    return tile


def _device_rows_per_block(Np: int, block: int, itemsize: int,
                           requested: Optional[int]) -> Optional[int]:
    """Rows per device-matrix buffer, a multiple of the tile ``block``
    (tiles must not straddle buffers); ``None`` = one (Np, Np) buffer.
    ``requested`` rounds down to the block grid; auto splits only when the
    single buffer would exceed ``ABNET3_ABX_DEVMAT_GB`` (default 6 GiB),
    the JAX package's policy, so both packages lay a matrix out alike.
    ``itemsize``: the bytes stored per value (2 for u16 codes, 4 for
    dtw_kl's float32)."""
    if requested is not None:
        rows = max(block, (requested // block) * block)
        return rows if rows < Np else None
    budget = float(os.environ.get("ABNET3_ABX_DEVMAT_GB", "6"))
    budget_bytes = int(budget * (1 << 30))
    if Np * Np * itemsize <= budget_bytes:
        return None
    per = budget_bytes // max(1, Np * itemsize)
    return max(block, (per // block) * block)


class _DeviceTiles:
    """The (Np, Np) device matrix that ``distance_matrix(device_out=True)``
    assembles tile by tile: one buffer, or equal-height row blocks of
    ``rows_pb`` rows (a multiple of the tile side, so every tile's rows
    lie in one block). u16 codes are stored in the int16 offset form
    (:func:`abnet3_torch.eval.abx_device.u16_wire`), dtw_kl's values as
    float32."""

    def __init__(self, N: int, Np: int, rows_pb: Optional[int], u16: bool,
                 device):
        self.N, self.Np, self.u16 = N, Np, u16
        self.height = Np if rows_pb is None else rows_pb
        n_blocks = -(-Np // self.height)
        self.starts = [b * self.height for b in range(n_blocks)]
        # every value starts as distance 0 (code 0), as in the JAX package
        zero = -abx_device.U16_OFFSET if u16 else 0.0
        self.zero = zero
        self.blocks = [torch.full((self.height, Np), zero,
                                  dtype=torch.int16 if u16 else torch.float32,
                                  device=device) for _ in self.starts]

    def _put(self, i0: int, j0: int, w: torch.Tensor) -> None:
        b = min(i0 // self.height, len(self.blocks) - 1)
        r = i0 - self.starts[b]
        self.blocks[b][r:r + w.shape[0], j0:j0 + w.shape[1]] = w

    def write(self, i0: int, j0: int, tile: torch.Tensor) -> None:
        """One encoded tile (int32 u16 codes, or float32) at (i0, j0): an
        off-diagonal tile and its transpose, or a diagonal tile as its
        mirrored upper triangle (the host drain's selection; the mirror
        runs on the int32 codes, before they narrow: torch has no triu
        for 16-bit unsigned values)."""
        if i0 == j0:
            tile = torch.triu(tile) + torch.triu(tile, 1).T
        w = abx_device.u16_wire(tile) if self.u16 else tile
        self._put(i0, j0, w)
        if i0 != j0:
            self._put(j0, i0, w.T)

    def handle(self):
        """Zero the diagonal last and hand the blocks over."""
        for s, blk in zip(self.starts, self.blocks):
            r = torch.arange(self.height, device=blk.device)
            keep = s + r < self.Np
            blk[r[keep], s + r[keep]] = self.zero
        return abx_device.DeviceMatrix(blocks=self.blocks,
                                       row_starts=self.starts, n=self.N)


def _tiles_distance_matrix(bank, distance, batch_size, max_frames,
                           out_dtype, checkpoint_path=None, device_out=False,
                           host_out=True, device_rows_per_block=None,
                           mesh=None):
    """Tile strategy: token ids split into tiles of ``block`` ids; only
    the upper tiles run, results mirror. Tiles leave the card u16-coded
    (float32 for dtw_kl) and dequantize on the host; with ``device_out``
    they also land in a device matrix (see :func:`distance_matrix`)."""
    N = len(bank)
    device = bank.bank.device
    T = max_frames if max_frames is not None else bank.max_len
    u16_wire = distance != "dtw_kl"
    n_data = _n_data(mesh)
    block = _auto_block(N, T, batch_size, n_data=n_data,
                        itemsize=2 if u16_wire else 4,
                        fetch_capped=host_out)
    encode = _encode_tile_u16 if u16_wire else (lambda d: d)
    decode = (_decode_tile_u16 if u16_wire
              else lambda q, dt: np.asarray(q, dtype=dt))
    if distance == "mean_cos":
        pooled = _pooled_token_vectors(bank, max_frames)

        def tile(ids_i, ids_j):
            v1 = pooled[_ids(ids_i, device)]
            v2 = pooled[_ids(ids_j, device)]
            return pairwise_angular_distance(v1[None], v2[None])[0]
    else:
        tile = _dtw_tile_fn(bank, distance, T, block, block // n_data)
    if n_data > 1:
        row_tile = tile

        def tile(ids_i, ids_j):
            # this rank's rows of the tile, gathered
            return _rows_on_mesh(mesh, len(ids_i), lambda a, b: row_tile(
                ids_i[a:b], ids_j))

    n_tiles = (N + block - 1) // block
    starts = [t * block for t in range(n_tiles)]
    # padded to whole tiles, so every tile write lies inside the buffer
    Np = n_tiles * block
    rows_pb = (_device_rows_per_block(Np, block, 2 if u16_wire else 4,
                                      device_rows_per_block)
               if device_out else None)

    def tile_ids(t):
        ids = np.arange(starts[t], min(starts[t] + block, N), dtype=np.int64)
        pad = block - len(ids)
        if pad:  # pad with token 0; its rows/cols are discarded
            ids = np.concatenate([ids, np.zeros(pad, np.int64)])
        return ids

    done: set = set()
    meta = {"N": N, "block": block, "dtype": np.dtype(out_dtype).name,
            "distance": distance, "max_frames": max_frames, "T": T,
            "wire": "u16" if u16_wire else "f32",
            # this package's tiles round differently from both JAX
            # backends ('path-stats', 'path-stats-pallas'), and on the
            # card (cuBLAS, the CUDA kernel) differently from the CPU:
            # tiles of one algo never mix with another's
            "algo": f"abnet3_torch-{device.type}"}
    if checkpoint_path is not None:
        mat_path = checkpoint_path + ".npy"
        prog_path = checkpoint_path + ".tiles.json"
        resume = False
        if os.path.exists(mat_path) and os.path.exists(prog_path):
            with open(prog_path) as f:
                prog = json.load(f)
            recorded = {k: prog.get(k) for k in meta}
            layout = {k: v for k, v in meta.items() if k != "algo"}
            if recorded == meta:
                done = {tuple(t) for t in prog["done"]}
                resume = True
            elif {k: recorded[k] for k in layout} == layout:
                # same layout, other numerics: resuming would mix tiles of
                # two algorithms, discarding would lose computed ones
                raise RuntimeError(
                    f"checkpoint {checkpoint_path} was computed with algo "
                    f"{recorded['algo']!r}, this run computes "
                    f"{meta['algo']!r}; refusing to mix them or discard "
                    "its completed tiles (finish it with the package and "
                    "device that wrote it, or delete it)")
            else:
                print("distance_matrix: discarding stale checkpoint "
                      f"at {checkpoint_path} (layout changed: "
                      f"{recorded} != {meta})")
        from abnet3_torch.dist import barrier, is_writer
        writes = is_writer()
        # every rank has read the checkpoint before rank 0 writes it
        barrier()
        if writes:
            D = np.lib.format.open_memmap(
                mat_path, mode="r+" if resume else "w+", dtype=out_dtype,
                shape=(N, N))
        else:  # another rank of a mesh: rank 0 keeps the checkpoint
            D = (np.array(np.load(mat_path, mmap_mode="r")) if resume
                 else np.zeros((N, N), out_dtype))
        if resume and done:
            print(f"distance_matrix: resuming {checkpoint_path}: "
                  f"{len(done)}/{n_tiles * (n_tiles + 1) // 2} tiles "
                  "already computed")

        def record(ti, tj):
            done.add((ti, tj))
            if not writes:
                return
            D.flush()
            tmp = prog_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(dict(meta, done=sorted(done)), f)
            os.replace(tmp, prog_path)
    else:
        D = np.zeros((N, N), out_dtype) if host_out else None

        def record(ti, tj):
            pass

    # tiles restored from a checkpoint never reached the card, and a
    # mesh row-shards the finished host matrix: the device matrix is then
    # uploaded from it
    dev = (_DeviceTiles(N, Np, rows_pb, u16_wire, device)
           if device_out and not done and mesh is None else None)
    # on a mesh the tiles' wire values, row-sharded at the end
    wire = (np.zeros((N, N), np.uint16 if u16_wire else np.float32)
            if device_out and not done and mesh is not None else None)
    pending: List[Tuple[int, int, torch.Tensor]] = []
    window = 4

    def drain_one():
        with span("abx.drain"):
            ti, tj, out = pending.pop(0)
            i0, j0 = starts[ti], starts[tj]
            ni = min(block, N - i0)
            nj = min(block, N - j0)
            raw = out.cpu().numpy()[:ni, :nj]
            vals = decode(raw, out_dtype)
            if tj == ti:
                # a diagonal tile computes both orders of each pair, and
                # DTW(i,j) vs DTW(j,i) may round one u16 step apart:
                # mirror the upper triangle so the matrix is exactly
                # symmetric
                vals = np.triu(vals) + np.triu(vals, 1).T
                raw = np.triu(raw) + np.triu(raw, 1).T
            D[i0:i0 + ni, j0:j0 + nj] = vals
            if tj != ti:
                D[j0:j0 + nj, i0:i0 + ni] = vals.T
            if wire is not None:
                wire[i0:i0 + ni, j0:j0 + nj] = raw
                if tj != ti:
                    wire[j0:j0 + nj, i0:i0 + ni] = raw.T
            record(ti, tj)

    n_run = 0
    for ti in range(n_tiles):
        ids_i = tile_ids(ti)
        for tj in range(ti, n_tiles):
            if (ti, tj) in done:
                continue
            with span("abx.tile", n_run):
                out = encode(tile(ids_i, tile_ids(tj)))
                if dev is not None:
                    dev.write(starts[ti], starts[tj], out)
                if host_out:
                    pending.append((ti, tj, out))
                    if len(pending) >= window:
                        drain_one()
            n_run += 1
    while pending:
        drain_one()
    if host_out:
        np.fill_diagonal(D, 0)
    if not device_out:
        return D
    if dev is not None:
        return D, dev.handle()
    if mesh is not None:
        # the tiles' wire values, as the mesh-free device matrix holds
        # them (a resumed checkpoint uploads its host matrix, as there)
        if wire is not None:
            np.fill_diagonal(wire, 0)
        return D, abx_device.upload_matrix(
            wire if wire is not None else np.asarray(D), device=device,
            mesh=mesh)
    if rows_pb is not None:
        # lazy host blocks straight over the checkpoint memmap: no copy
        # of the whole matrix, one block on the card at a time
        return D, abx_device.upload_matrix(D, rows_per_block=rows_pb,
                                           lazy=True, device=device)
    return D, abx_device.upload_matrix(np.asarray(D), device=device)


def distance_matrix(bank, distance: str = "dtw_cos",
                    batch_size: int = 1024, mesh=None,
                    max_frames: Optional[int] = None,
                    out_dtype=np.float32,
                    strategy: str = "auto",
                    checkpoint_path: Optional[str] = None,
                    device_out: bool = False,
                    host_out: bool = True,
                    device_rows_per_block: Optional[int] = None):
    """All-pairs normalized token distances: (N, N) ``out_dtype`` host
    matrix, zero diagonal, symmetric.

    - ``'pairs'``: flat fixed-size pair batches (``batch_size`` pairs
      each, (B, T, T) distances, the stats kernel on them);
    - ``'tiles'``: (block, block) tiles, block = min(batch_size, a 2^26
      transient cap, ~N/4, a 2 MB tile while tiles are fetched), each row
      one anchor against the tile's columns in the rows layout; tiles
      leave the card as uint16 fixed point (max error 7.6e-6; float32 for
      dtw_kl).
    - ``'auto'``: pairs below 2048 tokens, tiles from there (mean_cos
      always tiles: its tile is one matmul).

    ``checkpoint_path`` (tiles; ``'auto'`` then tiles) makes the run
    resumable: the matrix lives in a ``<path>.npy`` memmap, each drained
    tile is recorded in ``<path>.tiles.json``, and a rerun with the same
    path computes only the missing tiles. A checkpoint of another layout
    is discarded; one of the same layout whose ``algo`` is another
    package's or device's raises and is left as it is.

    ``device_out=True`` returns ``(D, DeviceMatrix)``: the tiles also land
    in a device matrix on the bank's device, padded to whole tiles, which
    :func:`abnet3_torch.eval.abx_device.abx_error_device` scores in place.
    ``device_rows_per_block`` (or automatically past
    ``ABNET3_ABX_DEVMAT_GB``) stores it as row blocks. A resumed
    checkpoint uploads its host matrix instead (lazy blocks over the
    memmap when blocked), as does the pairs strategy.

    ``host_out=False`` (with ``device_out``, without a checkpoint) fetches
    no tile: the first element of the pair is ``None``, and the tile side
    loses its 2 MB fetch cap.

    ``mesh``: the pair batches or the tile rows split over the mesh's
    'data' axis and gathered (the tile side a multiple of the axis, as
    in the JAX package); every rank returns the whole host matrix, and
    with ``device_out`` its rows of the row-sharded device matrix
    (:func:`abnet3_torch.eval.abx_device.upload_matrix`), built from the
    host matrix: ``host_out`` and ``device_rows_per_block`` stay at
    their defaults."""
    assert distance in ("dtw_cos", "dtw_kl", "mean_cos")
    assert strategy in ("auto", "pairs", "tiles")
    if mesh is not None and (not host_out
                             or device_rows_per_block is not None):
        raise ValueError("a mesh row-shards the device matrix from the "
                         "host matrix: host_out=False and "
                         "device_rows_per_block do not apply")
    if not host_out:
        if not device_out:
            raise ValueError("host_out=False without device_out=True "
                             "would compute nothing")
        if checkpoint_path is not None:
            raise ValueError("host_out=False cannot checkpoint (tiles "
                             "are never fetched to the host)")
    if checkpoint_path is not None and strategy != "tiles":
        if strategy == "pairs":
            raise ValueError("checkpoint_path requires the tiles "
                             "strategy (the pair stream has no tile "
                             "granularity to resume at)")
        strategy = "tiles"  # auto: checkpointing implies tiles
    N = len(bank)
    with torch.no_grad(), full_float32():
        if strategy == "pairs" or (strategy == "auto"
                                   and distance != "mean_cos"
                                   and N < _TILE_MIN_TOKENS):
            D = _pairs_distance_matrix(bank, distance, batch_size,
                                       max_frames, out_dtype, mesh=mesh)
            if device_out:
                return D, abx_device.upload_matrix(
                    D, device=bank.bank.device, mesh=mesh)
            return D
        return _tiles_distance_matrix(
            bank, distance, batch_size, max_frames, out_dtype,
            checkpoint_path=checkpoint_path, device_out=device_out,
            host_out=host_out, device_rows_per_block=device_rows_per_block,
            mesh=mesh)


def _block_err(dab: np.ndarray, dax: np.ndarray,
               b_mask: Optional[np.ndarray] = None) -> float:
    """Summed triplet error for a block of anchors sharing B/X sets:
    dab (n_a, n_b) anchor-to-B distances, dax (n_a, n_x) anchor-to-X
    distances -> sum over (a, b, x) of 1[dab > dax] + 0.5 * 1[==]
    (ties count 0.5, ABXpy semantics). ``b_mask`` (n_a, n_b) excludes
    per-anchor invalid B entries (the anchor itself in within cells).

    Broadcasting for small blocks; per-anchor sort + searchsorted
    (O((n_b + n_x) log n_x) per anchor) when the (n_a, n_b, n_x) cube
    would blow past ~4M elements — at ZeroSpeech scale the cube per
    cell is far too big to materialize."""
    n_a, n_b = dab.shape
    n_x = dax.shape[1]
    if n_a * n_b * n_x <= (1 << 22):
        cmp_gt = dab[:, :, None] > dax[:, None, :]
        cmp_eq = dab[:, :, None] == dax[:, None, :]
        if b_mask is not None:
            cmp_gt = cmp_gt & b_mask[:, :, None]
            cmp_eq = cmp_eq & b_mask[:, :, None]
        return float(np.sum(cmp_gt) + 0.5 * np.sum(cmp_eq))
    err = 0.0
    for a in range(n_a):
        xs = np.sort(dax[a])
        row = dab[a] if b_mask is None else dab[a][b_mask[a]]
        lo = np.searchsorted(xs, row, "left")    # # x < dab
        hi = np.searchsorted(xs, row, "right")   # # x <= dab
        err += float(lo.sum()) + 0.5 * float((hi - lo).sum())
    return err


def _abx_across_one(ca, state):
    """Across-task cells for one anchor class: every (ca, s) anchor
    group x every class co-occurring with s. Returns the per-(ca, cx)
    error/count partials — each ca is owned by exactly one worker, so
    merging partials across workers is plain disjoint dict update and
    the result is bit-identical to the serial enumeration (accumulation
    order within a key, s then cx sorted, lives entirely here)."""
    D, speakers, by_class, by_cs, spk_classes, spks = state
    all_a = by_class[ca]
    a_spks = speakers[all_a]
    cell_err: Dict[Tuple, float] = {}
    cell_cnt: Dict[Tuple, int] = {}
    for s in spks:
        a_idx = by_cs.get((ca, s))
        if a_idx is None:
            continue
        b_idx = all_a[a_spks != s]
        if len(b_idx) == 0:
            continue
        dab = D[np.ix_(a_idx, b_idx)]
        n_ab = len(a_idx) * len(b_idx)
        for cx in spk_classes[s]:
            if cx == ca:
                continue
            x_idx = by_cs[cx, s]
            err = _block_err(dab, D[np.ix_(a_idx, x_idx)])
            key = (ca, cx)
            cell_err[key] = cell_err.get(key, 0.0) + err
            cell_cnt[key] = cell_cnt.get(key, 0) + n_ab * len(x_idx)
    return cell_err, cell_cnt


def _abx_within_one(ca, state):
    """Within-task cells for one anchor class (see _abx_across_one for
    the ownership/merge contract)."""
    D, speakers, by_class, by_cs, spk_classes, spks = state
    cells: List[Tuple[Tuple, float, int]] = []
    for s in spks:
        ab = by_cs.get((ca, s))
        if ab is None or len(ab) < 2:
            continue
        mask = ~np.eye(len(ab), dtype=bool)
        dab = D[np.ix_(ab, ab)]
        for cx in spk_classes[s]:
            if cx == ca:
                continue
            x = by_cs[cx, s]
            err = _block_err(dab, D[np.ix_(ab, x)], b_mask=mask)
            cnt = len(ab) * (len(ab) - 1) * len(x)
            cells.append(((ca, cx, s), err, cnt))
    return cells


# fork-worker state: set by abx_error around the pool's lifetime; the
# children inherit it (and the big distance matrix) copy-on-write, so
# nothing is pickled per task but the class chunks. The children run pure
# numpy over inherited read-only arrays and never touch torch or the
# card.
_FORK_STATE = None


def _abx_fork_worker(args):
    task, ca_chunk = args
    one = _abx_across_one if task == "across" else _abx_within_one
    return [one(ca, _FORK_STATE) for ca in ca_chunk]


def _fork_map(task, classes, state, n_jobs):
    """Run the per-class scorers over a fork pool; returns the per-class
    results in ``classes`` order (exactly what the serial loop yields)."""
    import multiprocessing as mp
    global _FORK_STATE
    ctx = mp.get_context("fork")
    chunks = [classes[i::n_jobs * 4] for i in range(n_jobs * 4)]
    chunks = [c for c in chunks if c]
    _FORK_STATE = state
    try:
        with ctx.Pool(n_jobs) as pool:
            parts = pool.map(_abx_fork_worker,
                             [(task, c) for c in chunks])
    finally:
        _FORK_STATE = None
    # un-interleave back to `classes` order
    out = [None] * len(classes)
    pos = {ca: i for i, ca in enumerate(classes)}
    for chunk, res in zip(chunks, parts):
        for ca, r in zip(chunk, res):
            out[pos[ca]] = r
    return out


def abx_error(D: np.ndarray, labels: Sequence, speakers: Sequence,
              task: str = "across", by: Optional[Sequence] = None,
              n_jobs: int = 1, return_cells: bool = False) -> Dict:
    """Hierarchical ABX error from a precomputed distance matrix.

    Returns {"error", "n_cells", "n_triplets"}; error is the mean over
    non-empty cells of the per-cell triplet error (ties count 0.5).
    ``return_cells=True`` adds ``"cells"``: the per-cell breakdown as
    ``(key, score, n_triplets)`` tuples in sorted-key order — the
    ABXpy ``analyze`` collapse level (key = (ca, cx) for across,
    (ca, cx, speaker) for within, with the by-group key prefixed under
    ``by`` conditioning). The aggregate error is exactly
    ``mean(score for each cell)`` — same accumulation, just exposed.

    ``by``: optional per-token group keys (ABXpy's BY-conditioning, e.g.
    phonetic context tuples): A, B and X must all share the same key, so
    cells become (by, ...) and the returned error is the uniform mean
    over all cells of all groups — exactly the unconditioned enumeration
    run inside each group. ABXpy task model: on/across/by columns
    (docs in the task files the reference defers to, README.md:3).

    Vectorized per (cell, anchor-speaker) block: within one cell every
    anchor of one speaker shares the same B set (same class, other
    speakers) and X set (other class, anchor's speaker), so the triplet
    counting runs as whole-matrix comparisons / searchsorted rank counts
    instead of per-anchor Python loops.

    ``n_jobs > 1`` scores anchor classes in parallel over a fork
    process pool (children inherit the distance matrix copy-on-write —
    nothing is pickled but class ids). Each class is owned by exactly
    one worker and partials merge by disjoint keys in class order, so
    the result is BIT-IDENTICAL to n_jobs=1. Falls back to serial where
    fork is unavailable; use n_jobs <= cores."""
    assert task in ("across", "within")
    labels = np.asarray(labels)
    speakers = np.asarray(speakers)
    N = len(labels)
    assert D.shape == (N, N) and len(speakers) == N
    if by is not None:
        assert len(by) == N
        groups: Dict = {}
        for i, b in enumerate(by):
            groups.setdefault(b, []).append(i)
        err_sum, n_cells, n_trip = 0.0, 0, 0
        by_cells: List[Tuple[Tuple, float, int]] = []
        for key in sorted(groups):
            idx = np.asarray(groups[key], dtype=np.int64)
            sub = abx_error(D[np.ix_(idx, idx)], labels[idx],
                            speakers[idx], task=task, n_jobs=n_jobs,
                            return_cells=return_cells)
            if sub["n_cells"]:
                err_sum += sub["error"] * sub["n_cells"]
                n_cells += sub["n_cells"]
                n_trip += sub["n_triplets"]
            if return_cells:
                pfx = key if isinstance(key, tuple) else (key,)
                by_cells.extend((pfx + k, v, c)
                                for k, v, c in sub["cells"])
        out = {"error": (err_sum / n_cells if n_cells
                         else float("nan")),
               "n_cells": n_cells, "n_triplets": n_trip}
        if return_cells:
            out["cells"] = by_cells
        return out
    # no dtype upcast: > / == on float16 values give identical results
    # to comparing their exact float32 images, and a full-matrix astype
    # would allocate the 2x copy the --f16 flag exists to avoid
    classes = sorted(set(labels.tolist()))
    spks = sorted(set(speakers.tolist()))
    # index lists per class and per (class, speaker), built in one
    # O(N log N) pass (a classes x speakers scan would be |C|*|S| masks)
    by_class = {c: np.flatnonzero(labels == c) for c in classes}
    by_cs: Dict[Tuple, np.ndarray] = {}
    spk_classes: Dict[object, List] = {s: [] for s in spks}
    for c in classes:
        idx = by_class[c]
        c_spks = speakers[idx]
        order = np.argsort(c_spks, kind="stable")
        uniq, starts = np.unique(c_spks[order], return_index=True)
        bounds = np.append(starts, len(order))
        for u, s0, s1 in zip(uniq.tolist(), bounds[:-1], bounds[1:]):
            by_cs[c, u] = idx[order[s0:s1]]
            spk_classes[u].append(c)

    # enumerate only NON-EMPTY (class, speaker) anchor groups and the
    # classes actually co-occurring with each anchor's speaker: real STD
    # inventories run to thousands of mostly-disjoint classes, where the
    # full |C|^2 x |S| cross-product is ~1e8+ empty dict probes while
    # the occupied cells are a sparse fraction.
    # Accumulation order (ca, then s, then cx — all sorted) reproduces
    # the cross-product enumeration bit-exactly; the fork path keeps it
    # because each ca's cells are computed whole inside one worker and
    # merged back in class order (_abx_across_one/_fork_map).
    import multiprocessing as mp
    use_fork = (n_jobs > 1 and len(classes) > 1
                and "fork" in mp.get_all_start_methods())
    state = (D, speakers, by_class, by_cs, spk_classes, spks)
    n_triplets = 0
    if task == "across":
        # one cell per (ca, cx): A any token of ca; B same class but NOT
        # A's speaker; X class cx with A's speaker
        if use_fork:
            per_class = _fork_map("across", classes, state,
                                  min(n_jobs, len(classes)))
        else:
            per_class = (_abx_across_one(ca, state) for ca in classes)
        cell_err: Dict[Tuple, float] = {}
        cell_cnt: Dict[Tuple, int] = {}
        for err_part, cnt_part in per_class:
            cell_err.update(err_part)   # keys disjoint across classes
            cell_cnt.update(cnt_part)
        cell_list = [(k, cell_err[k] / cell_cnt[k], cell_cnt[k])
                     for k in sorted(cell_err)]
        cell_scores = [v for _, v, _ in cell_list]
        n_triplets = sum(cell_cnt.values())
    else:
        # within: one cell per (ca, cx, speaker); B = the other
        # same-class same-speaker tokens (anchor excluded)
        if use_fork:
            per_class = _fork_map("within", classes, state,
                                  min(n_jobs, len(classes)))
        else:
            per_class = (_abx_within_one(ca, state) for ca in classes)
        cells: List[Tuple[Tuple, float, int]] = []
        for part in per_class:
            for key, err, cnt in part:
                n_triplets += cnt
                cells.append((key, err / cnt, cnt))
        cell_list = sorted(cells, key=lambda kv: kv[0])
        cell_scores = [v for _, v, _ in cell_list]

    out = {"error": (float(np.mean(cell_scores))
                     if cell_scores else float("nan")),
           "n_cells": len(cell_scores),
           "n_triplets": int(n_triplets)}
    if return_cells:
        out["cells"] = cell_list
    return out


def read_item_file(path: str):
    """ABXpy ``.item`` task-file reader — the ecosystem's interchange
    format for phone-level ABX tasks (the reference defers scoring to
    ABXpy over the exported h5features, reference README.md:3,
    embedder.py:98-100). Format: a ``#file onset offset #col1 col2 ...``
    header, then one token per line::

        #file onset offset #phone prev-phone next-phone speaker
        s0101a 0.3225 0.5225 ny ao dx s01

    Returns ``(columns, rows)``: the attribute-name list (header names
    after onset/offset, ``#`` markers stripped) and
    ``(file, onset, offset, {attr: value})`` tuples. Feed the result to
    :func:`evaluate` by passing the ``.item`` path as ``classes_path``
    (``item_on`` picks the class attribute, default the first one —
    e.g. ``phone``; ``item_speaker`` the speaker attribute, default
    ``speaker``/``talker``)."""
    columns = None
    rows = []
    with open(path) as fh:
        for ln, line in enumerate(fh, 1):
            parts = line.split()
            if not parts:
                continue
            if parts[0].startswith("#"):
                names = [p.lstrip("#") for p in parts]
                if columns is None and names[:3] == ["file", "onset",
                                                     "offset"]:
                    columns = names[3:]
                # any other '#' line (before or after the header) is a
                # comment — real .item files carry generator banners
                continue
            if columns is None:
                raise ValueError(f"{path}:{ln}: missing '#file onset "
                                 "offset ...' header line")
            if len(parts) != 3 + len(columns):
                raise ValueError(
                    f"{path}:{ln}: expected {3 + len(columns)} columns "
                    f"({['file', 'onset', 'offset'] + columns}), got "
                    f"{len(parts)}")
            rows.append((parts[0], float(parts[1]), float(parts[2]),
                         dict(zip(columns, parts[3:]))))
    if columns is None:
        raise ValueError(f"{path}: empty item file")
    return columns, rows


def _write_cells_csv(path: str, cells: List[Tuple], task: str,
                     by_cols: Optional[Sequence[str]]) -> None:
    """Per-cell breakdown -> tab-separated CSV, one row per occupied
    cell in sorted-key order (the ABXpy ``analyze`` collapse level:
    its pipeline ends in a per-cell score table, which is what
    downstream error analyses consume). Columns: the by-conditioning
    attributes (if any), class_A, class_X, speaker (within task),
    score (full-precision repr), n (triplet count)."""
    import csv
    cols = list(by_cols or [])
    cols += ["class_A", "class_X"]
    if task == "within":
        cols.append("speaker")
    cols += ["score", "n"]
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh, delimiter="\t")
        w.writerow(cols)
        for key, score, cnt in cells:
            w.writerow([str(k) for k in key]
                       + [repr(float(score)), int(cnt)])


def evaluate(features_path: str, classes_path: str,
             spkid_file: Optional[str] = None, task: str = "across",
             distance: str = "dtw_cos", batch_size: int = 1024,
             max_frames: Optional[int] = None, mesh=None,
             out_dtype=np.float32,
             checkpoint_path: Optional[str] = None,
             item_on: Optional[str] = None,
             item_speaker: Optional[str] = None,
             item_by: Optional[Sequence[str]] = None,
             n_jobs: int = 1,
             score_backend: str = "auto",
             cells_path: Optional[str] = None,
             device_rows_per_block: Optional[int] = None,
             device=None) -> Dict:
    """End-to-end ABX over an h5features file and a token inventory:
    either a ``.classes`` cluster file (with an optional wav->speaker
    mapping, the sampler's file contracts) or an ABXpy ``.item`` task file
    (``classes_path`` ending in ``.item``; per-token class and speaker
    come from its attribute columns, ``item_on``/``item_speaker`` select
    them, ``item_by`` names columns to condition on).

    The corpus is streamed: only the token slices the inventory names are
    kept. The token bank and the distances run on ``device`` (default the
    card; ``device="cpu"`` runs the plain versions on the CPU).

    ``score_backend``: where the triplet aggregation runs.

    - ``'host'``: the numpy occupied-cell scorer (:func:`abx_error`,
      honours ``n_jobs``).
    - ``'device'``: :func:`abnet3_torch.eval.abx_device.abx_error_device`
      on ``device``, over the matrix ``distance_matrix(device_out=True)``
      leaves there; the tiles are not fetched unless ``checkpoint_path``
      keeps the host matrix. Bit-identical error.
    - ``'auto'`` (default): device from 2,048 tokens (the tile strategy's
      scale), host below; also host when a cell of the inventory carries
      2^24 triplets or more (checked before the distance stage), where
      ``'device'`` raises.

    ``checkpoint_path`` makes the distance stage resumable and
    ``device_rows_per_block`` lays the device matrix out in row blocks
    (:func:`distance_matrix`). ``mesh`` (or a YAML dict ``{data: N}``)
    splits the distance stage and the device scorer over the mesh's
    'data' axis (:func:`distance_matrix`); every rank returns the result
    and rank 0 alone writes ``cells_path``.
    """
    from abnet3_torch.io.h5f import iter_h5features
    from abnet3_torch.ops.bank import TokenBank
    from abnet3_torch.sampler import SamplerClusterSiamese
    from abnet3_torch.utils import (Features_Accessor, read_spkid_file,
                                    resolve_device)

    device = resolve_device(device)
    assert score_backend in ("auto", "host", "device")
    if isinstance(mesh, dict):
        from abnet3_torch.parallel import make_mesh
        mesh = make_mesh(n_data=mesh.get("data"),
                         n_model=mesh.get("model", 1), device=device)
    spkid = read_spkid_file(spkid_file) if spkid_file else None
    # token specs (label, file, on, off, speaker-or-None, by-key) in
    # inventory order, grouped by file for the single streaming pass
    if classes_path.endswith(".item"):
        columns, rows = read_item_file(classes_path)
        on_col = item_on if item_on is not None else columns[0]
        spk_col = item_speaker
        if spk_col is None:
            spk_col = next((c for c in ("speaker", "talker")
                            if c in columns), None)
        for col, what in ((on_col, "item_on"), (spk_col, "item_speaker")):
            if col not in columns:
                raise ValueError(
                    f"{classes_path}: no {what} column {col!r} among "
                    f"{columns}")
        for col in (item_by or ()):
            if col not in columns:
                raise ValueError(
                    f"{classes_path}: no item_by column {col!r} among "
                    f"{columns}")
        specs = [(attrs[on_col], f, on, off, attrs[spk_col],
                  tuple(attrs[c] for c in item_by) if item_by else None)
                 for f, on, off, attrs in rows]
        n_inventory_classes = len({s[0] for s in specs})
    else:
        if item_by:
            raise ValueError("item_by conditioning needs an ABXpy .item "
                             "task file (no attribute columns in "
                             ".classes inventories)")
        clusters = SamplerClusterSiamese().parse_input_file(classes_path)
        specs = [(ci, f, on, off, None, None)
                 for ci, cluster in enumerate(clusters)
                 for f, on, off in cluster]
        n_inventory_classes = len(clusters)
    by_file: Dict[str, List[int]] = {}
    for k, (_, f, *_rest) in enumerate(specs):
        by_file.setdefault(f, []).append(k)
    feat_by_spec: Dict[int, np.ndarray] = {}
    missing = set(by_file)
    for item, labs, feats in iter_h5features(features_path, "features"):
        ks = by_file.get(item)
        if ks is None:
            continue
        missing.discard(item)
        for k in ks:
            on, off = specs[k][2], specs[k][3]
            seg = Features_Accessor.get_features_between(
                feats, labs, on, off)
            if len(seg):
                feat_by_spec[k] = np.asarray(seg, np.float32)
    if missing:
        raise KeyError("items named by %s but absent from %s: %s"
                       % (classes_path, features_path,
                          sorted(missing)[:5]))
    token_feats, labels, speakers, by_keys = {}, [], [], []
    tid = 0
    for k, (label, f, _, _, spk, bkey) in enumerate(specs):
        feat = feat_by_spec.get(k)
        if feat is None:  # zero frames in [on, off]
            continue
        token_feats[tid] = feat
        labels.append(label)
        if spk is None:
            spk = spkid[f] if spkid else f
        speakers.append(spk)
        by_keys.append(bkey)
        tid += 1
    if not token_feats:
        raise ValueError(
            "no usable tokens: every [on, off] window in %s selected "
            "zero frames of %s — check that the task times use the same "
            "unit/offset as the feature time labels"
            % (classes_path, features_path))
    bank = TokenBank(token_feats, max_frames=max_frames, device=device)
    by = by_keys if item_by else None
    use_device = (score_backend == "device"
                  or (score_backend == "auto"
                      and len(bank) >= _TILE_MIN_TOKENS))
    # checked before the distance stage: a run that fetches no tile has
    # no host matrix to fall back to
    if use_device and not abx_device.device_scorable(labels, speakers,
                                                     task, by=by):
        if score_backend == "device":
            raise ValueError(
                "score_backend='device': a cell of this inventory "
                "carries >= 2^24 triplets (float32 device bins "
                "would round); use the host backend")
        use_device = False
    # a device-scored run fetches the tiles only to keep a checkpoint
    result = distance_matrix(
        bank, distance=distance, batch_size=batch_size,
        max_frames=max_frames, out_dtype=out_dtype,
        checkpoint_path=checkpoint_path, device_out=use_device,
        host_out=((not use_device) or checkpoint_path is not None
                  or mesh is not None),
        device_rows_per_block=device_rows_per_block if use_device else None,
        mesh=mesh)
    want_cells = cells_path is not None
    if use_device:
        out = abx_device.abx_error_device(result[1], labels, speakers,
                                          task=task, by=by,
                                          return_cells=want_cells)
    else:
        out = abx_error(result, labels, speakers, task=task, by=by,
                        n_jobs=n_jobs, return_cells=want_cells)
    if want_cells:
        from abnet3_torch.dist import is_writer
        cells = out.pop("cells")
        if is_writer():
            _write_cells_csv(cells_path, cells, task,
                             item_by if item_by else None)
        out["cells_csv"] = cells_path
    # n_classes reports the INVENTORY's class count (stable metadata even
    # when a class's tokens all resolve to empty feature segments)
    out.update({"task": task, "distance": distance, "n_tokens": tid,
                "n_classes": n_inventory_classes})
    if item_by:
        out["by"] = list(item_by)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="ABX discriminability evaluation (PyTorch/CUDA)")
    parser.add_argument("features", help="h5features file to score")
    parser.add_argument("classes",
                        help=".classes token inventory, or an ABXpy "
                             ".item task file (per-token class/speaker "
                             "from its attribute columns)")
    parser.add_argument("-s", "--spkid-file",
                        help="wav->speaker mapping (one 'file spk' per "
                             "line); defaults to per-file speakers "
                             "(.classes inventories only)")
    parser.add_argument("--on", dest="item_on", default=None,
                        help=".item files: attribute column holding the "
                             "class label (default: the first one)")
    parser.add_argument("--speaker-col", dest="item_speaker", default=None,
                        help=".item files: attribute column holding the "
                             "speaker (default: speaker/talker)")
    parser.add_argument("--by", dest="item_by", action="append",
                        default=None, metavar="COL",
                        help=".item files: condition triplets on this "
                             "attribute column, ABXpy-style (repeatable)")
    parser.add_argument("-t", "--task", default="across",
                        choices=["across", "within"])
    parser.add_argument("-d", "--distance", default="dtw_cos",
                        choices=["dtw_cos", "dtw_kl", "mean_cos"],
                        help="dtw_kl is the posteriorgram metric "
                             "(symmetrised KL along the DTW path)")
    parser.add_argument("-b", "--batch-size", type=int, default=1024)
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--f16", action="store_true",
                        help="store the host distance matrix as float16")
    parser.add_argument("-j", "--n-jobs", type=int, default=1,
                        help="parallel scoring workers (fork pool; "
                             "results are bit-identical to -j 1; host "
                             "backend only)")
    parser.add_argument("--score-backend", default="auto",
                        choices=["auto", "host", "device"],
                        help="where triplet aggregation runs: 'device' "
                             "scores on --device over the device-resident "
                             "distance matrix (bit-identical error); "
                             "'auto' picks device from 2,048 tokens")
    parser.add_argument("--device-rows-per-block", type=int,
                        default=None, metavar="ROWS",
                        help="store the device-resident distance matrix "
                             "as row blocks of this many rows (automatic "
                             "past ABNET3_ABX_DEVMAT_GB, default 6 GiB)")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="make the (tiles-strategy) distance matrix "
                             "resumable: tiles land in <path>.npy + "
                             "<path>.tiles.json; rerunning with the "
                             "same path computes only the missing tiles")
    parser.add_argument("--device", default=None,
                        help="torch device of the distances (default: "
                             "the card; 'cpu' runs the plain versions)")
    parser.add_argument("-o", "--output", help="write the result JSON "
                                               "here as well as stdout")
    parser.add_argument("--csv", dest="cells_path", default=None,
                        metavar="PATH",
                        help="also write the per-cell score breakdown "
                             "as a tab-separated CSV")
    args = parser.parse_args(argv)
    result = evaluate(args.features, args.classes,
                      spkid_file=args.spkid_file, task=args.task,
                      distance=args.distance, batch_size=args.batch_size,
                      max_frames=args.max_frames,
                      out_dtype=np.float16 if args.f16 else np.float32,
                      item_on=args.item_on,
                      item_speaker=args.item_speaker,
                      item_by=args.item_by,
                      n_jobs=args.n_jobs,
                      score_backend=args.score_backend,
                      checkpoint_path=args.checkpoint,
                      device_rows_per_block=args.device_rows_per_block,
                      cells_path=args.cells_path,
                      device=args.device)
    line = json.dumps(result)
    print(line)
    if args.output:
        with open(args.output, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
