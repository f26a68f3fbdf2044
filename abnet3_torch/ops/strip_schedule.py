"""The lane-skewed schedule of the strip kernels, emulated on the CPU.

``csrc/dtw_strip.cuh`` runs one warp per pair: lane ``l`` owns a strip of
``W`` neighbouring columns and computes row ``s - l`` of it at step ``s``;
the cell left of its strip comes from lane ``l - 1`` by a shuffle (that
lane's value of the step before), the cell above-left of the strip is the
shuffled value of the step before that, planes wider than ``32 * W``
columns run in column chunks whose last column is carried, and the rows
of costs go through a ring of ``lanes + prefetch`` slots. A CUDA kernel
cannot run without a card, so this module repeats that schedule with numpy
in float32, register by register: :func:`emulate_strip` gives the costs,
moves, chain lengths and the step at which each cell was computed,
:func:`ring_schedule` replays the ring's slots, and :func:`emulate_path`
repeats what ``csrc/dtw_path.cu`` does around the core: the move plane's
words and addresses, the walk's lane keys and max reduction, and the row
writes. The tests hold them against the plain versions, which is the
rehearsal of the kernels' index arithmetic that a machine without a card
allows.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from abnet3_torch.ops.cuda_dtw import STRIP_PREFETCH, strip_geometry

__all__ = ["StripRun", "emulate_strip", "ring_schedule", "PathRun",
           "emulate_path"]

_BIG = np.float32(1e30)
_LANES = 32


class StripRun(NamedTuple):
    """What one emulated launch computed. ``step`` and ``slot`` are -1
    and ``count`` 0 on cells outside a pair's (n1, n2) sub-grid."""
    costs: np.ndarray    # (B, T1, T2) float32, D
    moves: np.ndarray    # (B, T1, T2) int8, 3=diag 2=up 1=left
    length: np.ndarray   # (B, T1, T2) int32, L: the argmin chain's length
    count: np.ndarray    # (B, T1, T2) int32, times the cell was computed
    step: np.ndarray     # (B, T1, T2) int64, the step (chunks in sequence)
    slot: np.ndarray     # (B, T1, T2) int32, position in its lane's strip
    psum: np.ndarray     # (B,) float32, D[n1-1, n2-1] or 0
    plen: np.ndarray     # (B,) float32, L[n1-1, n2-1] or 0
    steps: np.ndarray    # (B,) int64, dependent steps of each pair


def emulate_strip(dist: np.ndarray, n1: Optional[np.ndarray] = None,
                  n2: Optional[np.ndarray] = None) -> StripRun:
    """Run the strip schedule on dist (B, T1, T2) float32. Without
    lengths every pair covers the whole padded plane (the move and cost
    kernels); with n1/n2 (B,) each pair covers its n1 x n2 cells and the
    result is read at (n1-1, n2-1), lengths outside [1, T] giving (0, 0)
    (the stats kernel)."""
    dist = np.ascontiguousarray(dist, dtype=np.float32)
    B, T1, T2 = dist.shape
    with_lengths = n1 is not None
    geo = strip_geometry(B, T1, T2, 2 if with_lengths else 1)
    W, chunk = geo.strip, 32 * geo.strip
    rows = np.full(B, T1) if n1 is None else np.asarray(n1, dtype=np.int64)
    cols = np.full(B, T2) if n2 is None else np.asarray(n2, dtype=np.int64)
    valid = (rows >= 1) & (rows <= T1) & (cols >= 1) & (cols <= T2)
    rows = np.where(valid, rows, 0)
    cols = np.where(valid, cols, 0)

    D = np.zeros((B, T1, T2), np.float32)
    mv = np.zeros((B, T1, T2), np.int8)
    L = np.zeros((B, T1, T2), np.int32)
    count = np.zeros((B, T1, T2), np.int32)
    step_of = np.full((B, T1, T2), -1, np.int64)
    slot_of = np.full((B, T1, T2), -1, np.int32)
    carry_d = np.full((B, max(T1, 1)), _BIG, np.float32)
    carry_l = np.zeros((B, max(T1, 1)), np.int32)
    steps = np.zeros(B, np.int64)
    lane = np.arange(_LANES)[None, :]                      # (1, 32)
    pair = np.arange(B)[:, None]
    clock = 0
    n_chunks = int(-(-cols.max() // chunk)) if B else 0
    for ch in range(n_chunks):
        col0 = ch * chunk
        ccols = np.clip(cols - col0, 0, chunk)[:, None]    # (B, 1)
        lanes = -(-ccols // W)
        has_next = (cols[:, None] - col0) > chunk
        chunk_steps = np.where(ccols[:, 0] > 0,
                               rows + lanes[:, 0] - 1, 0)
        steps += chunk_steps
        # a lane's registers
        up = np.full((B, _LANES, W), _BIG, np.float32)
        lup = np.zeros((B, _LANES, W), np.int32)
        corner = np.full((B, _LANES), _BIG, np.float32)
        lcorner = np.zeros((B, _LANES), np.int32)
        if ch == 0:     # the best neighbour of the cell (0, 0) is 0
            corner[:, 0] = 0
        for s in range(int(chunk_steps.max()) if B else 0):
            row = s - lane                                  # (1, 32)
            active = ((lane < lanes) & (row >= 0) & (row < rows[:, None])
                      & (s < chunk_steps[:, None]))
            # the shuffle: every lane reads lane l-1's last column as the
            # step before left it; lane 0 takes the carried column
            left = np.roll(up[:, :, W - 1], 1, axis=1)
            lleft = np.roll(lup[:, :, W - 1], 1, axis=1)
            srow = min(s, T1 - 1)
            left[:, 0] = carry_d[:, srow] if ch > 0 else _BIG
            lleft[:, 0] = carry_l[:, srow] if ch > 0 else 0
            dg, ldg = corner.copy(), lcorner.copy()
            corner = np.where(active, left, corner)
            lcorner = np.where(active, lleft, lcorner)
            r = np.clip(row, 0, T1 - 1)
            for w in range(W):
                col = col0 + lane * W + w                   # (1, 32)
                inside = active & (lane * W + w < ccols)
                cost = dist[pair, r, np.minimum(col, T2 - 1)]
                u, lu = up[:, :, w].copy(), lup[:, :, w].copy()
                # the kernel's two comparisons for the plain version's
                # three: left unless min(diag, up) <= left, then diag if
                # diag <= up, else up
                diag_first = dg <= u
                m = np.minimum(dg, u)
                not_left = m <= left
                value = (cost + np.minimum(m, left)).astype(np.float32)
                length = 1 + np.where(not_left,
                                      np.where(diag_first, ldg, lu), lleft)
                code = np.where(not_left, np.where(diag_first, 3, 2),
                                1).astype(np.int8)
                b_i, l_i = np.nonzero(inside)
                r_i, c_i = r[0, l_i], col[0, l_i]
                D[b_i, r_i, c_i] = value[b_i, l_i]
                mv[b_i, r_i, c_i] = code[b_i, l_i]
                L[b_i, r_i, c_i] = length[b_i, l_i]
                count[b_i, r_i, c_i] += 1
                step_of[b_i, r_i, c_i] = clock + s
                slot_of[b_i, r_i, c_i] = w
                dg, ldg = u, lu
                left = np.where(active, value, left)
                lleft = np.where(active, length, lleft)
                up[:, :, w] = np.where(active, value, u)
                lup[:, :, w] = np.where(active, length, lu)
            # the chunk's last lane leaves its last column for the next
            writer = active & has_next & (lane == lanes - 1)
            b_i, l_i = np.nonzero(writer)
            carry_d[b_i, r[0, l_i]] = up[b_i, l_i, W - 1]
            carry_l[b_i, r[0, l_i]] = lup[b_i, l_i, W - 1]
        clock += int(chunk_steps.max()) if B else 0
    at = (np.arange(B), np.maximum(rows - 1, 0), np.maximum(cols - 1, 0))
    if T1 == 0 or T2 == 0:
        psum = plen = np.zeros(B, np.float32)
    else:
        psum = np.where(valid, D[at], np.float32(0)).astype(np.float32)
        plen = np.where(valid, L[at], 0).astype(np.float32)
    return StripRun(D, mv, L, count, step_of, slot_of, psum, plen, steps)


def ring_schedule(rows: int, lanes: int, ring_rows: int,
                  prefetch: int = STRIP_PREFETCH) -> int:
    """Replay the ring of cost rows of one chunk: ``prefetch`` rows are
    requested before step 0 and row 0 awaited; at step ``s`` lane ``l``
    reads row ``s - l``, then row ``s + 1`` is awaited and row
    ``s + prefetch`` requested into the next slot. Raises AssertionError
    if a lane would read a slot that holds another row, or a row that no
    wait has covered yet; returns the reads made."""
    held = [-1] * ring_rows          # the row each slot holds
    for r in range(min(prefetch, rows)):
        held[r % ring_rows] = r
    landed = 0                       # rows 0..landed have been awaited
    reads = 0
    fill = prefetch % ring_rows
    slot = [-l for l in range(lanes)]
    for s in range(rows + lanes - 1):
        for l in range(lanes):
            row = s - l
            if 0 <= row < rows:
                assert held[slot[l]] == row, (s, l, row, held[slot[l]])
                assert row <= landed, (s, l, row, landed)
                reads += 1
            slot[l] = 0 if slot[l] + 1 == ring_rows else slot[l] + 1
        # all but the newest prefetch - 2 requests have landed
        landed = s + 1
        if s + prefetch < rows:
            held[fill] = s + prefetch
        fill = 0 if fill + 1 == ring_rows else fill + 1
    return reads


class PathRun(NamedTuple):
    """What one emulated launch of the path kernel did."""
    mask: np.ndarray     # (B, T1, T2) float32, the mask as written
    writes: np.ndarray   # (B, T1, T2) int32, times each element was written
    plane: np.ndarray    # (B, T1 * move_pitch) uint8, the move plane
    stored: np.ndarray   # (B, T1 * move_pitch) int32, move stores per byte
    keys: np.ndarray     # (B, T1) int64, the key the walk left in each row
    runs: np.ndarray     # (B, T1, 2) int64, [lo, hi] of each row's run
    walk_steps: np.ndarray  # (B,) int64, cells the walk visited


def emulate_path(dist: np.ndarray, n1: np.ndarray, n2: np.ndarray,
                 garbage: int = 3) -> PathRun:
    """Run the path kernel's schedule on dist (B, T1, T2) float32 with
    lengths n1/n2 (B,). The forward pass is :func:`emulate_strip` over
    each pair's n1 x n2 cells; each lane stores the W moves of each row of
    its strip as one word at ``row * move_pitch + col0 + lane * W`` of the
    pair's plane. Columns of a lane's last strip past n2-1 hold a move of
    costs the ring never received: they are stored as ``garbage`` (3, a
    diagonal move, by default) so that a walk that read one would go
    wrong. Then lane 0 walks the plane from (n1-1, n2-1) one cell a step
    and leaves in the first word of each row it leaves the key 2 lo +
    (move is diag), -1 past column 0; rows above a walk that left the
    plane get -1. Last the warp writes the rows from the keys, 16 bytes a
    lane where T2 % 4 == 0, else 4; rows from n1 on (all rows of a pair
    with lengths outside [1, T]) are zeros written first."""
    dist = np.ascontiguousarray(dist, dtype=np.float32)
    B, T1, T2 = dist.shape
    n1 = np.asarray(n1, dtype=np.int64)
    n2 = np.asarray(n2, dtype=np.int64)
    geo = strip_geometry(B, T1, T2, 1, move_plane=True)
    W, chunk, pitch = geo.strip, 32 * geo.strip, geo.move_pitch
    fwd = emulate_strip(dist, n1, n2)
    valid = (n1 >= 1) & (n1 <= T1) & (n2 >= 1) & (n2 <= T2)

    plane = np.zeros((B, T1 * pitch), np.uint8)
    stored = np.zeros((B, T1 * pitch), np.int32)
    flat = np.zeros((B, T1 * T2), np.float32)
    writes = np.zeros((B, T1 * T2), np.int32)
    keys = np.full((B, T1), -1, np.int64)
    runs = np.zeros((B, T1, 2), np.int64)
    runs[:, :, 1] = -1
    walk_steps = np.zeros(B, np.int64)
    width = 4 if T2 % 4 == 0 else 1      # floats a lane stores at once

    def warp_store(b, start, n, lo=0, hi=-1):
        """The warp's stores of n floats from ``start`` (whole rows): lane
        l takes the pieces l, l + 32, ... of ``width`` floats; an element
        of column lo..hi of its row is 1, any other 0."""
        for ln in range(_LANES):
            pieces = np.arange(ln * width, n, _LANES * width)
            at = (start + pieces[:, None] + np.arange(width)).ravel()
            assert (at < start + n).all(), "a piece leaves the rows"
            col = at % T2
            flat[b, at] = ((col >= lo) & (col <= hi)) * 1.0
            np.add.at(writes[b], at, 1)

    def put_key(b, row, key):
        """The int32 key at the first word of the row (little endian)."""
        plane[b, row * pitch:row * pitch + 4] = np.array(
            [key], "<i4").view(np.uint8)

    def key_of(b, row):
        return int(plane[b, row * pitch:row * pitch + 4].view("<i4")[0])

    for b in range(B):
        a, c = (int(n1[b]), int(n2[b])) if valid[b] else (0, 0)
        # the rows the path cannot reach, zeroed first by the warp
        warp_store(b, a * T2, (T1 - a) * T2)
        if not valid[b]:
            continue
        # the forward pass: each owning lane's word of each row
        for col0 in range(0, c, chunk):
            owners = -(-min(chunk, c - col0) // W)
            # (lane, w): the columns of each owning lane's word
            cols = col0 + np.arange(owners)[:, None] * W + np.arange(W)
            assert cols.max() < pitch, "a word leaves its row"
            rows = np.arange(a)[:, None, None]
            at = rows * pitch + cols[None]
            word = np.where(cols[None] < c,
                            fwd.moves[b, rows, np.minimum(cols, T2 - 1)[None]],
                            garbage)
            plane[b, at] = word
            np.add.at(stored[b], at.ravel(), 1)
        # the walk, by lane 0: a row's key replaces its first word when
        # the walk leaves it, so a read must never meet a keyed row
        i, j, left_rows = a - 1, c - 1, set()
        while True:
            assert i not in left_rows, "the walk read a keyed row"
            m = int(plane[b, i * pitch + j])
            walk_steps[b] += 1
            if m == 1:
                j -= 1
                if j >= 0:
                    continue
                put_key(b, i, -1)
                break
            diag = int(m == 3)
            put_key(b, i, 2 * j + diag)
            left_rows.add(i)
            j -= diag
            if i == 0 or j < 0:
                break
            i -= 1
        for row in range(i):           # the rows above a walk that left
            put_key(b, row, -1)
        # the rows of the mask, from the keys
        hi = c - 1
        for row in range(a - 1, -1, -1):
            k = key_of(b, row)
            lo = max(k >> 1, 0)
            keys[b, row], runs[b, row] = k, (lo, hi)
            warp_store(b, row * T2, T2, lo, hi)
            hi = (k >> 1) - (k & 1)
    return PathRun(flat.reshape(B, T1, T2), writes.reshape(B, T1, T2),
                   plane, stored, keys, runs, walk_steps)
