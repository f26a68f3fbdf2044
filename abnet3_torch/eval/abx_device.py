"""ABX triplet scoring on the card, over a device-resident distance matrix.

The counterpart of ``abnet3_tpu/eval/abx_device.py``: the same tables, the
same slot geometry and the same float64 finishing, so the result is
bit-identical to the JAX package's device scorer and to the host scorer
(:func:`abnet3_torch.eval.abx.abx_error`) on the same matrix.

Design
------
- Within one (class_A, speaker, by-group) anchor pool every anchor shares
  its B set (across: the class's tokens of other speakers; within: the
  class's other tokens of the speaker) and draws X from one candidate
  pool (the tokens of (speaker, group)). Anchors are scored in slots of
  ``A`` anchors, ``P`` slots a chunk (``P * A = chunk``): one row gather
  of the matrix per anchor gives d(a, B) and d(a, X), a masked comparison
  cube reduced over B gives per-(anchor, x) greater and equal counts.
- Each pool's X table is sorted by class, so one scatter-add over the X
  axis collapses the counts to class columns, and one ``index_add_`` of
  the anchor rows lands them in the cell bins. Bin rows are composite
  (by-group, class) ids, so BY-conditioning runs in the same single pass;
  the within task's rows are the occupied (speaker, class) pairs, so it
  too is one pass.
- Counts accumulate in float32 bins, exact for integers below 2^24 (a
  guard refuses larger cells); scatter order is irrelevant for exact
  integers. The 0.5 tie weight, the per-cell division and the mean over
  cells run on the host in float64, in sorted cell-key order: the host
  scorer's arithmetic.
- Comparisons run in the matrix's own values: u16 codes as integers
  (which order exactly like their dequantized float32 images), float
  matrices as float32 (float16 values compare like their exact float32
  images).
- The occupied submatrix of the bins is the only thing fetched: rows and
  columns with a positive analytic count. Every cell the finishing reads
  lies inside it, so the result is the same as a full fetch; the port
  always fetches this way (the JAX package can switch it off with
  ``ABNET3_ABX_COMPACT=0``, with bit-identical results either way).

Storage
-------
A :class:`DeviceMatrix` is a list of equal-height row blocks on the card
(one block for the single-buffer case), or, with ``lazy``, host row
blocks (numpy or ``np.memmap`` views) that the scorer copies to the card
one at a time, so a matrix larger than the card's memory scores off a
``distance_matrix`` checkpoint. u16 codes are stored in 2 bytes as
``int16(code - 32768)``: torch's ``uint16`` lacks most operations on both
devices, and the offset keeps order and equality.

A CPU matrix is scored on the CPU and a CUDA matrix on the card; nothing
falls back from one to the other.

Mesh
----
``upload_matrix(mesh=...)`` row-shards the matrix over the mesh's 'data'
axis (one process per GPU): each rank holds one block of Np / n_data
rows (Np padded up to the axis), exclusive with ``rows_per_block`` and
``lazy`` as in the JAX package. The scorer then scores the anchors of its
rows only and sums the count bins over 'data' before the fetch; the
counts are exact integers, so the result is bit-identical to one rank's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from abnet3_torch.utils import pow2_bucket, resolve_device

__all__ = ["DeviceMatrix", "upload_matrix", "abx_error_device",
           "device_scorable", "u16_wire"]

# anchor slots per chunk: P pools x A anchors with P*A = 256 keeps the
# (P, A, max_b, max_x) comparison cube in the tens of MB at ZeroSpeech
# shapes (max_b ~ 64, max_x ~ 1,500)
_CHUNK = 256

# float32 bins hold exact integer counts only below 2^24: a cell with
# more triplets would round, so the scorer refuses it
_F32_EXACT = 1 << 24

# u16 code c is stored as int16 c - 32768 (order and equality kept)
U16_OFFSET = 32768


def u16_wire(codes: torch.Tensor) -> torch.Tensor:
    """u16 tile codes (held in int32) -> the device matrix's int16 form."""
    return (codes - U16_OFFSET).to(torch.int16)


def _host_to_wire(a: np.ndarray) -> torch.Tensor:
    """A host matrix or row block -> a CPU tensor in the stored form:
    float64 narrows to float32 (as the JAX upload does), uint16 codes take
    the int16 offset form, every other dtype stays."""
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.uint16:
        a = (a.astype(np.int32) - U16_OFFSET).astype(np.int16)
    return torch.from_numpy(np.array(a))


class DeviceMatrix:
    """Handle to an (Np, Np) distance matrix on a device.

    ``blocks`` are equal-height row blocks (the last of a host upload may
    be shorter) starting at global rows ``row_starts``; the single-buffer
    case is one block, also ``.array``. ``n`` is the true token count:
    buffers may pad beyond it (whole tiles, whole blocks). ``lazy``: the
    blocks are host arrays, copied to ``device`` one at a time while
    scoring. ``mesh``: the one block is this rank's rows of a matrix
    row-sharded over the mesh's 'data' axis."""

    def __init__(self, array=None, n: int = 0, blocks=None,
                 row_starts: Optional[Sequence[int]] = None,
                 lazy: bool = False, device=None, mesh=None):
        if blocks is None:
            assert array is not None
            blocks = [array]
            row_starts = [0]
        assert len(blocks) == len(row_starts)
        self.blocks = list(blocks)
        self.row_starts = [int(r) for r in row_starts]
        self.n = int(n)
        self.lazy = bool(lazy)
        self.device = (torch.device(device) if device is not None
                       else self.blocks[0].device)
        assert not self.lazy or device is not None, \
            "lazy blocks need the device they are scored on"
        self.mesh = mesh
        self.group = None
        if mesh is not None:
            assert len(self.blocks) == 1 and not self.lazy, \
                "mesh sharding, row blocks and lazy blocks are exclusive"
            n_data = int(mesh.size(mesh.mesh_dim_names.index("data")))
            if n_data > 1:
                self.group = mesh.get_group("data")

    @property
    def array(self):
        """The single storage buffer (row-blocked handles have none)."""
        assert len(self.blocks) == 1, "row-blocked matrix has no " \
                                      "single .array; use .blocks"
        return self.blocks[0]

    @property
    def rows_per_block(self) -> int:
        return int(self.blocks[0].shape[0])

    def block_of(self, row: int) -> int:
        """Index of the block owning global ``row``."""
        return min(row // self.rows_per_block, len(self.blocks) - 1)

    def numpy(self) -> np.ndarray:
        """The (n, n) matrix on the host, u16 codes back as uint16 (on a
        mesh gathered from every rank: a collective)."""
        blocks = self.blocks
        if self.group is not None:
            from abnet3_torch.dist import all_gather_rows
            blocks = [all_gather_rows(self.blocks[0], self.group,
                                      dist.get_world_size(self.group))]
        parts = [b if self.lazy else b.cpu().numpy() for b in blocks]
        m = np.concatenate(parts, axis=0)[:self.n, :self.n]
        if m.dtype == np.int16:
            m = (m.astype(np.int32) + U16_OFFSET).astype(np.uint16)
        return m

    def __len__(self):
        return self.n


def upload_matrix(D: np.ndarray, rows_per_block: Optional[int] = None,
                  lazy: bool = False, device=None,
                  mesh=None) -> DeviceMatrix:
    """Host (N, N) matrix -> :class:`DeviceMatrix` on ``device`` (default
    the card), one copy per buffer. float64 narrows to float32, uint16
    codes take the int16 offset form, every other dtype uploads as it is,
    so the device compares what the host scorer compares.

    ``rows_per_block``: store as row blocks of that height. ``lazy`` (with
    ``rows_per_block``): keep the blocks on the host as views of ``D``
    (which may be an ``np.memmap``); the scorer copies one block at a
    time to the device.

    ``mesh``: row-shard over the mesh's 'data' axis (see the module);
    exclusive with ``rows_per_block`` and ``lazy``."""
    device = resolve_device(device)
    N = D.shape[0]
    if mesh is not None:
        if rows_per_block is not None or lazy:
            raise ValueError("mesh sharding and rows_per_block / lazy "
                             "blocks are exclusive")
        from abnet3_torch.dist import block
        n_data = int(mesh.size(mesh.mesh_dim_names.index("data")))
        rank = mesh.get_local_rank("data") if n_data > 1 else 0
        Np = -(-N // n_data) * n_data
        r0, r1 = block(Np, n_data, rank)
        rows = np.asarray(D[r0:min(r1, N)])
        if r1 > N:  # padded rows: never an anchor
            rows = np.concatenate([rows, np.zeros((r1 - max(r0, N), N),
                                                  rows.dtype)])
        return DeviceMatrix(blocks=[_host_to_wire(rows).to(device)],
                            row_starts=[r0], n=N, mesh=mesh)
    if lazy:
        if rows_per_block is None:
            raise ValueError("lazy blocks need rows_per_block")
        rows_per_block = min(rows_per_block, N)
        starts = list(range(0, N, rows_per_block))
        return DeviceMatrix(blocks=[D[r:r + rows_per_block] for r in starts],
                            row_starts=starts, n=N, lazy=True, device=device)
    if rows_per_block is not None and rows_per_block < N:
        starts = list(range(0, N, rows_per_block))
        return DeviceMatrix(
            blocks=[_host_to_wire(D[r:r + rows_per_block]).to(device)
                    for r in starts], row_starts=starts, n=N)
    return DeviceMatrix(_host_to_wire(D).to(device), N)


def _compare_dtype(blk: torch.Tensor) -> torch.dtype:
    """Integer storage compares as int32 (u16 code order is the
    dequantized float order), float storage as float32 (float16 values
    compare like their exact float32 images)."""
    return torch.float32 if blk.is_floating_point() else torch.int32


def _score_chunk(blk: torch.Tensor, row_off: int, statics: Tuple,
                 chunk_tabs: Tuple, i: int, gt_bins: torch.Tensor,
                 eq_bins: torch.Tensor) -> None:
    """Score chunk ``i``, a (P, A) grid of pool slots, against each slot's
    B sets and its pool's class-sorted X table, adding greater and equal
    counts into the (n_rows + 1, Ccols) float32 bins in place (row n_rows
    is the dump row of padded anchors). ``blk`` holds the anchors' rows,
    starting at global row ``row_off``; its columns span the matrix."""
    row_tab, b_ids_tab, b_cnt_tab, x_ids_tab, x_seg_tab, x_cnt_tab = statics
    sel_tab, valid_tab, pool_tab = chunk_tabs
    a_ids = sel_tab[i]                                  # (P, A)
    a_valid = valid_tab[i]                              # (P, A) bool
    pools = pool_tab[i]                                 # (P,)
    P, A = a_ids.shape
    max_b = b_ids_tab.shape[1]
    max_x = x_ids_tab.shape[1]
    n_rows, Ccols = gt_bins.shape[0] - 1, gt_bins.shape[1]
    device = gt_bins.device
    x_ids = x_ids_tab[pools]                            # (P, max_x)
    x_seg = x_seg_tab[pools]
    x_cnt = x_cnt_tab[pools]                            # (P,)
    flat = a_ids.reshape(-1)                            # (P*A,)
    # JAX clamps an out-of-range gather; torch does not (on the card an
    # index past the end is a device-side assert, a negative one wraps).
    # Padded anchors carry token id 0, which lies outside every block but
    # the first: clamp them into the block; a_valid masks their counts.
    local = (flat - row_off).clamp_(0, blk.shape[0] - 1)
    rows = blk[local]                                   # (P*A, width)
    cdt = _compare_dtype(blk)
    dab = torch.gather(rows, 1, b_ids_tab[flat]).to(cdt).reshape(
        P, A, max_b)
    dax = torch.gather(rows.reshape(P, A, -1), 2,
                       x_ids[:, None, :].expand(P, A, max_x)).to(cdt)
    vb = (torch.arange(max_b, device=device)[None, None, :]
          < b_cnt_tab[flat].reshape(P, A)[:, :, None])[:, :, :, None]
    # padded X slots are masked here; the anchor's own class lands in the
    # (ca, ca) diagonal bin, which is never read
    vx = ((torch.arange(max_x, device=device)[None, None, :]
           < x_cnt[:, None, None]) & a_valid[:, :, None])
    # the bool cube sums into int32: exact, and half of int64's bytes
    gt = ((dab[:, :, :, None] > dax[:, :, None, :]) & vb).sum(
        2, dtype=torch.int32)                           # (P, A, max_x)
    eq = ((dab[:, :, :, None] == dax[:, :, None, :]) & vb).sum(
        2, dtype=torch.int32)
    gt = torch.where(vx, gt, 0).to(torch.float32)
    eq = torch.where(vx, eq, 0).to(torch.float32)
    # collapse each slot's class-sorted X axis to group-local class
    # columns (segment Ccols takes the padding)
    seg = x_seg[:, None, :].expand(P, A, max_x)
    gt_c = gt.new_zeros((P, A, Ccols + 1)).scatter_add_(2, seg, gt)
    eq_c = eq.new_zeros((P, A, Ccols + 1)).scatter_add_(2, seg, eq)
    # add the P*A anchor rows into the cell bins (rows repeated across
    # slots add exact integers: order-free)
    row = torch.where(a_valid, row_tab[a_ids], n_rows).reshape(-1)
    gt_bins.index_add_(0, row, gt_c[:, :, :Ccols].reshape(-1, Ccols))
    eq_bins.index_add_(0, row, eq_c[:, :, :Ccols].reshape(-1, Ccols))


def _sub_gather(gt_bins: torch.Tensor, eq_bins: torch.Tensor,
                rows: np.ndarray, cols: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
    """The occupied (rows, cols) submatrix of both bins, fetched to the
    host. The JAX package pads the index lists to power-of-two lengths
    (one compiled gather for every pass) with sentinels that its clamping
    gather maps into range; torch compiles nothing and would assert on
    the sentinel column ``Ccols``, so the lists go unpadded."""
    r = torch.from_numpy(rows.astype(np.int64)).to(gt_bins.device)
    c = torch.from_numpy(cols.astype(np.int64)).to(gt_bins.device)
    return tuple(b.index_select(0, r).index_select(1, c).cpu().numpy()
                 for b in (gt_bins, eq_bins))


def _dense_ids(values: np.ndarray) -> Tuple[List, np.ndarray]:
    """values -> (sorted unique list, dense int32 ids in sorted order).
    Sorted order preserves the host scorer's sorted-cell-key order."""
    uniq = sorted(set(values.tolist()))
    pos = {v: i for i, v in enumerate(uniq)}
    return uniq, np.asarray([pos[v] for v in values.tolist()], np.int32)


def _composite_classes(labels: np.ndarray, by: Optional[Sequence]):
    """Dense COMPOSITE class ids over (by-group, label), group-major:
    group g's classes occupy composite rows [row_off[g], row_off[g+1])
    in sorted-label order (= the host scorer's per-group cell order).

    Returns (group_keys sorted, gid (N,), cls (N,) composite ids,
    row_off (G+1,), group_classes: per group the sorted label list)."""
    N = len(labels)
    if by is None:
        keys = [None]
        gid = np.zeros(N, np.int32)
    else:
        assert len(by) == N
        # plain-Python key handling: the host scorer sorts the raw by
        # keys (tuples), and np.asarray would mangle equal-length
        # tuples into a 2-D array
        keys = sorted(set(by))
        pos = {k: i for i, k in enumerate(keys)}
        gid = np.asarray([pos[b] for b in by], np.int32)
    G = len(keys)
    group_classes: List[List] = []
    row_off = np.zeros(G + 1, np.int64)
    cls = np.zeros(N, np.int32)
    for g in range(G):
        idx = np.flatnonzero(gid == g)
        uniq, local = _dense_ids(labels[idx])
        cls[idx] = local + row_off[g]
        group_classes.append(uniq)
        row_off[g + 1] = row_off[g] + len(uniq)
    return keys, gid, cls, row_off, group_classes


def _pool_tables(cls: np.ndarray, spk: np.ndarray, gid: np.ndarray,
                 row_off: np.ndarray, Ccols: int):
    """Per-(speaker, by-group) class-sorted X candidate tables:
    x_ids (P, max_x) GLOBAL token ids (pad 0, masked), x_seg (P, max_x)
    group-LOCAL class segment ids (pad Ccols = dump segment),
    x_cnt (P,), pool_spk (P,), plus token -> pool id (N,)."""
    N = len(cls)
    key = spk.astype(np.int64) * (int(gid.max()) + 1) + gid
    order = np.lexsort((cls, key))
    uniq, starts = np.unique(key[order], return_index=True)
    bounds = np.append(starts, N)
    P = len(uniq)
    counts = (bounds[1:] - bounds[:-1]).astype(np.int32)
    max_x = max(int(counts.max()) if P else 1, 1)
    x_ids = np.zeros((P, max_x), np.int32)
    x_seg = np.full((P, max_x), Ccols, np.int32)
    pool_spk = np.zeros(P, np.int32)
    pool_of = np.zeros(N, np.int32)
    for p in range(P):
        sel = order[bounds[p]:bounds[p + 1]]
        n = len(sel)
        x_ids[p, :n] = sel
        g = gid[sel[0]]
        x_seg[p, :n] = cls[sel] - row_off[g]
        pool_spk[p] = spk[sel[0]]
        pool_of[sel] = p
    return x_ids, x_seg, counts, pool_spk, pool_of, max_x


def _anchor_b_tables(cls: np.ndarray, spk: np.ndarray, Crows: int,
                     task: str):
    """Per-anchor B-set tables: b_ids (N, max_b) int32 GLOBAL token ids
    (pad 0, masked) and b_cnt (N,). Across: same composite class, other
    speakers. Within: same composite class, same speaker, anchor
    excluded. Composite classes never span by-groups, so B sets respect
    the conditioning for free."""
    N = len(cls)
    order = np.lexsort((spk, cls))
    starts = np.searchsorted(cls[order], np.arange(Crows))
    bounds = np.append(starts, N)
    b_lists: List[Optional[np.ndarray]] = [None] * N
    max_b = 1
    for c in range(Crows):
        idx = order[bounds[c]:bounds[c + 1]]
        if len(idx) < 2:
            continue
        spks_c = spk[idx]
        for u in np.unique(spks_c):
            anchors = idx[spks_c == u]
            if task == "across":
                blist = idx[spks_c != u]
                if len(blist):
                    for a in anchors:
                        b_lists[a] = blist
                    max_b = max(max_b, len(blist))
            else:
                if len(anchors) > 1:
                    for a in anchors:
                        b_lists[a] = anchors[anchors != a]
                    max_b = max(max_b, len(anchors) - 1)
    b_ids = np.zeros((N, max_b), np.int32)
    b_cnt = np.zeros(N, np.int32)
    for a in range(N):
        bl = b_lists[a]
        if bl is not None:
            b_ids[a, :len(bl)] = bl
            b_cnt[a] = len(bl)
    return b_ids, b_cnt, max_b


def _cell_counts(n_cs: np.ndarray, task: str) -> np.ndarray:
    """Analytic per-cell triplet counts from a (C, S) class-speaker
    histogram, float64 (exact: integer products far below 2^53).

    across (C, C):    cnt[ca,cx] = sum_s n[ca,s]*(N_ca - n[ca,s])*n[cx,s]
    within (C, C, S): cnt[ca,cx,s] = n[ca,s]*(n[ca,s]-1)*n[cx,s]"""
    A = n_cs.astype(np.float64)
    C = A.shape[0]
    if task == "across":
        n_class = A.sum(axis=1, keepdims=True)
        cnt = (A * (n_class - A)) @ A.T
        np.fill_diagonal(cnt, 0.0)
    else:
        cnt = (A * np.maximum(A - 1.0, 0.0))[:, None, :] * A[None, :, :]
        cnt[np.arange(C), np.arange(C), :] = 0.0
    return cnt


def device_scorable(labels: Sequence, speakers: Sequence,
                    task: str = "across",
                    by: Optional[Sequence] = None) -> bool:
    """True when the device scorer can count this inventory exactly
    (every cell below 2^24 triplets — the float32-bin exactness bound).
    Cheap (histogram math only): callers that want to skip the host
    matrix entirely check this BEFORE the distance stage, so no
    fallback ever needs a matrix that was never fetched. Without ``by``
    the check is conservative for by-conditioned runs (group cells are
    subsets of unconditioned cells)."""
    labels = np.asarray(labels)
    speakers = np.asarray(speakers)
    if not len(labels):
        return True
    _, spk = _dense_ids(speakers)
    _, gid, cls, row_off, _ = _composite_classes(labels, by)
    S = int(spk.max()) + 1
    Crows = int(row_off[-1])
    n_cs = np.zeros((Crows, S), np.int64)
    np.add.at(n_cs, (cls, spk), 1)
    worst = 0.0
    for g in range(len(row_off) - 1):
        cnt = _cell_counts(n_cs[row_off[g]:row_off[g + 1]], task)
        if cnt.size:
            worst = max(worst, float(cnt.max()))
    return worst < _F32_EXACT


def _to_device(a: np.ndarray, device, dtype=np.int64) -> torch.Tensor:
    """A host table -> the device, int64 by default (torch's gathers and
    scatters take int64 indices: converted once, not per chunk)."""
    return torch.from_numpy(np.asarray(a, dtype)).to(device)


def abx_error_device(D, labels: Sequence, speakers: Sequence,
                     task: str = "across",
                     by: Optional[Sequence] = None,
                     chunk: int = _CHUNK,
                     return_cells: bool = False, device=None) -> Dict:
    """Device-backed twin of :func:`abnet3_torch.eval.abx.abx_error`:
    the same inputs and result dict, a bit-identical ``error`` (module
    docstring). ``return_cells=True`` adds the per-cell ``"cells"``,
    ``(key, score, n_triplets)`` in sorted-key order, equal to the host
    scorer's.

    ``D``: a :class:`DeviceMatrix` (from ``distance_matrix(device_out=
    True)`` or :func:`upload_matrix`; single, row-blocked or lazy), scored
    on its own device, or a host (N, N) matrix, uploaded to ``device``
    (default the card) once there are cells to score. ``by``
    conditioning and the within task run in one pass each."""
    assert task in ("across", "within")
    labels = np.asarray(labels)
    speakers = np.asarray(speakers)
    N = len(labels)
    if isinstance(D, DeviceMatrix):
        assert D.n == N, (D.n, N)
        dm = D
    else:
        assert D.shape == (N, N)
        dm = None  # upload only if there are cells to score
    assert len(speakers) == N

    keys, gid, cls, row_off, group_classes = _composite_classes(labels,
                                                                by)
    spks, spk = _dense_ids(speakers)
    G, S = len(keys), len(spks)
    Crows = int(row_off[-1])
    Ccols = max(int(row_off[g + 1] - row_off[g]) for g in range(G))
    n_cs = np.zeros((Crows, S), np.int64)
    np.add.at(n_cs, (cls, spk), 1)

    cnts = [_cell_counts(n_cs[row_off[g]:row_off[g + 1]], task)
            for g in range(G)]
    if not any((c > 0).any() for c in cnts):
        out = {"error": float("nan"), "n_cells": 0, "n_triplets": 0}
        if return_cells:
            out["cells"] = []
        return out
    if max(float(c.max()) for c in cnts if c.size) >= _F32_EXACT:
        raise ValueError(
            "a single ABX cell carries >= 2^24 triplets — float32 "
            "device bins would round its counts; score this inventory "
            "with the host path (abx.abx_error)")
    if dm is None:
        dm = upload_matrix(D, device=device)
    device = dm.device

    x_ids, x_seg, x_cnt, pool_spk, pool_of, max_x = _pool_tables(
        cls, spk, gid, row_off, Ccols)
    b_ids, b_cnt, max_b = _anchor_b_tables(cls, spk, Crows, task)
    n_pools = len(x_cnt)

    # bin ROW id per token: the across task scatters into composite
    # class rows; the within task into dense OCCUPIED (speaker,
    # composite-class) rows so one pass covers every speaker's cells
    if task == "across":
        n_rows = Crows
        row_tab = cls
    else:
        occ_sc = np.zeros((S, Crows), bool)   # occupied (s, ca) rows
        for g in range(G):
            # (Cg, S) any-triplet mask over the anchor axis
            m = (cnts[g] > 0).any(axis=1)
            occ_sc[:, row_off[g]:row_off[g + 1]] = m.T
        lk = np.full((S, Crows), -1, np.int64)
        occ_s, occ_r = np.nonzero(occ_sc)     # s-major row order
        n_rows = len(occ_s)
        lk[occ_s, occ_r] = np.arange(n_rows)
        row_tab = lk[spk, cls]
        row_tab = np.where(row_tab < 0, n_rows, row_tab) \
            .astype(np.int32)                 # unoccupied -> dump row

    # slot geometry: A anchors per pool slot, P slots per chunk. Large
    # pools (unconditioned inventories) get A = chunk, P = 1; tiny
    # by-group pools pack many slots per chunk instead of padding each
    # to `chunk`.
    A = min(chunk, pow2_bucket(int(x_cnt.max()), minimum=8))
    P = max(1, chunk // A)

    # static tables: on the device once for the whole scoring run
    statics = tuple(_to_device(a, device) for a in (
        row_tab, b_ids, b_cnt, x_ids, x_seg, x_cnt))
    by_pool = [np.flatnonzero(pool_of == p) for p in range(n_pools)]
    rows_pb = dm.rows_per_block
    n_blocks = len(dm.blocks)

    def run_bins(occ_rows: Optional[np.ndarray],
                 occ_cols: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Score every pool's anchors into fresh bins; returns host
        float64 (n_rows, Ccols) greater/equal counts. With a row-blocked
        matrix the anchor slots partition by owning block and the bins
        thread through each block's chunk sequence. Only the occupied
        ``occ_rows`` (None: every row) x ``occ_cols`` submatrix is
        fetched (module docstring)."""
        per_block: List[Tuple[List, List, List]] = \
            [([], [], []) for _ in range(n_blocks)]
        for p in range(n_pools):
            anchors = by_pool[p]
            if dm.mesh is not None:
                # this rank's rows only; the bins are summed below
                r0 = dm.row_starts[0]
                anchors = anchors[(anchors >= r0) & (anchors < r0 + rows_pb)]
            if n_blocks > 1:
                owners = np.minimum(anchors // rows_pb, n_blocks - 1)
                splits = [anchors[owners == b] for b in range(n_blocks)]
            else:
                splits = [anchors]
            for b, blk_anchors in enumerate(splits):
                sels, valids, pool_ids = per_block[b]
                for c0 in range(0, len(blk_anchors), A):
                    sel = blk_anchors[c0:c0 + A].astype(np.int32)
                    a_valid = np.ones(A, bool)
                    pad = A - len(sel)
                    if pad:
                        a_valid[len(sel):] = False
                        sel = np.concatenate(
                            [sel, np.zeros(pad, np.int32)])
                    sels.append(sel)
                    valids.append(a_valid)
                    pool_ids.append(p)
        gt_bins = torch.zeros((n_rows + 1, Ccols), dtype=torch.float32,
                              device=device)
        eq_bins = torch.zeros_like(gt_bins)
        for b in range(n_blocks):
            sels, valids, pool_ids = per_block[b]
            if not sels:
                continue
            # pad the slot list to whole (P,) chunks with all-invalid
            # slots; their anchor id 0 may lie outside this block
            # (_score_chunk clamps it)
            while len(sels) % P:
                sels.append(np.zeros(A, np.int32))
                valids.append(np.zeros(A, bool))
                pool_ids.append(0)
            n_chunks = len(sels) // P
            # per-chunk tables: on the device once per block, chunk i
            # picked by indexing
            chunk_tabs = (
                _to_device(np.stack(sels).reshape(n_chunks, P, A), device),
                _to_device(np.stack(valids).reshape(n_chunks, P, A),
                           device, bool),
                _to_device(np.asarray(pool_ids).reshape(n_chunks, P),
                           device))
            # a lazy block is on the device only for its own chunks
            blk = (_host_to_wire(dm.blocks[b]).to(device) if dm.lazy
                   else dm.blocks[b])
            for i in range(n_chunks):
                _score_chunk(blk, dm.row_starts[b], statics, chunk_tabs,
                             i, gt_bins, eq_bins)
            del blk
        if dm.group is not None:
            dist.all_reduce(gt_bins, group=dm.group)
            dist.all_reduce(eq_bins, group=dm.group)
        rs = (np.arange(n_rows) if occ_rows is None else occ_rows)
        gt = np.zeros((n_rows, Ccols), np.float32)
        eq = np.zeros((n_rows, Ccols), np.float32)
        grid = np.ix_(rs, occ_cols)
        gt[grid], eq[grid] = _sub_gather(gt_bins, eq_bins, rs, occ_cols)
        return gt.astype(np.float64), eq.astype(np.float64)

    def occ_cols_of(blocks) -> np.ndarray:
        """Union of occupied LOCAL class columns over per-group count
        blocks ((Cg, Cg) each)."""
        cm = np.zeros(Ccols, bool)
        for blk in blocks:
            cm[np.flatnonzero((blk > 0).any(axis=0))] = True
        return np.flatnonzero(cm)

    def group_scores_across(err: np.ndarray, g: int) -> np.ndarray:
        """Group g's occupied-cell scores in sorted (ca, cx) order —
        a row-major boolean slice of the composite-row block."""
        lo, hi = int(row_off[g]), int(row_off[g + 1])
        Cg = hi - lo
        cnt = cnts[g]
        occ = cnt > 0
        return err[lo:hi, :Cg][occ] / cnt[occ]

    def group_cells_across(err: np.ndarray, g: int) -> List[Tuple]:
        """(key, score, count) rows for group g's occupied cells —
        row-major over the sorted-label block = sorted (ca, cx) order,
        scores elementwise-identical to group_scores_across."""
        lo = int(row_off[g])
        cnt = cnts[g]
        names = group_classes[g]
        pfx = (() if by is None else
               (keys[g] if isinstance(keys[g], tuple) else (keys[g],)))
        return [(pfx + (names[a], names[x]),
                 err[lo + a, x] / cnt[a, x], int(cnt[a, x]))
                for a, x in zip(*np.nonzero(cnt > 0))]

    if task == "across":
        occ = np.concatenate(
            [np.flatnonzero((cnts[g] > 0).any(axis=1)) + row_off[g]
             for g in range(G)])
        gt, eq = run_bins(occ, occ_cols_of(cnts))
        err = gt + 0.5 * eq
        if by is None:
            scores = group_scores_across(err, 0)
            out = {"error": (float(np.mean(scores)) if scores.size
                             else float("nan")),
                   "n_cells": int((cnts[0] > 0).sum()),
                   "n_triplets": int(cnts[0].sum())}
            if return_cells:
                out["cells"] = group_cells_across(err, 0)
            return out
        # host by-path arithmetic: sum of per-group mean * n_cells
        err_sum, n_cells, n_trip = 0.0, 0, 0
        by_cells: List[Tuple] = []
        for g in range(G):
            scores = group_scores_across(err, g)
            if scores.size:
                err_sum += float(np.mean(scores)) * scores.size
                n_cells += int(scores.size)
                n_trip += int(cnts[g].sum())
            if return_cells:
                by_cells.extend(group_cells_across(err, g))
        out = {"error": (err_sum / n_cells if n_cells
                         else float("nan")),
               "n_cells": n_cells, "n_triplets": n_trip}
        if return_cells:
            out["cells"] = by_cells
        return out

    # within: cells are (ca, cx, s); the bins already hold every
    # speaker's cells (occupied (s, ca) rows — one pass, one fetch)
    gt, eq = run_bins(None, occ_cols_of([(cnts[g] > 0).any(axis=2)
                                         for g in range(G)]))
    err = gt + 0.5 * eq
    # occupied row i is speaker occ_s[i], composite class occ_r[i]
    g_of = (np.searchsorted(row_off, occ_r, side="right") - 1
            if n_rows else np.zeros(0, np.int64))
    per_group: List[List[Tuple[Tuple, float, int]]] = [[] for _ in
                                                       range(G)]
    trip_group = [int(cnts[g].sum()) for g in range(G)]
    for i in range(n_rows):
        s, g = int(occ_s[i]), int(g_of[i])
        ca = int(occ_r[i] - row_off[g])
        cnt_row = cnts[g][ca, :, s]           # (Cg,)
        names = group_classes[g]
        for cx in np.flatnonzero(cnt_row > 0):
            per_group[g].append(
                ((names[ca], names[int(cx)], spks[s]),
                 err[i, cx] / cnt_row[cx], int(cnt_row[cx])))
    if by is None:
        cell_list = per_group[0]
        cell_list.sort(key=lambda kv: kv[0])
        scores = np.asarray([v for _, v, _ in cell_list], np.float64)
        out = {"error": (float(np.mean(scores)) if len(cell_list)
                         else float("nan")),
               "n_cells": len(cell_list),
               "n_triplets": trip_group[0]}
        if return_cells:
            out["cells"] = cell_list
        return out
    err_sum, n_cells, n_trip = 0.0, 0, 0
    by_cells = []
    for g in range(G):
        cell_list = per_group[g]
        if not cell_list:
            continue
        cell_list.sort(key=lambda kv: kv[0])
        scores = np.asarray([v for _, v, _ in cell_list], np.float64)
        err_sum += float(np.mean(scores)) * len(cell_list)
        n_cells += len(cell_list)
        n_trip += trip_group[g]
        if return_cells:
            pfx = keys[g] if isinstance(keys[g], tuple) else (keys[g],)
            by_cells.extend((pfx + k, v, c) for k, v, c in cell_list)
    out = {"error": (err_sum / n_cells if n_cells else float("nan")),
           "n_cells": n_cells, "n_triplets": n_trip}
    if return_cells:
        out["cells"] = by_cells
    return out
