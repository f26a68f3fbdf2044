// The warp-synchronous forward DP of DTW for Hopper (sm_90a): the core
// that csrc/dtw_moves.cu (moves, costs), csrc/dtw_path_stats.cu (path sum
// and length) and csrc/dtw_path.cu (path mask) share.
//
// One warp owns one pair. Lane l owns a strip of W neighbouring columns
// and walks down the rows one step behind lane l-1: at step s it computes
// row s - l of its strip, left to right. The cell above and the cell
// above-left are the lane's own registers from the step before. The one
// value a lane lacks, D[i, first-1], the cell left of its strip in its
// row, is what lane l-1 finished one step earlier and arrives by one
// __shfl_up_sync; the same value, kept for one more step, is the
// above-left neighbour of the strip's first column in the next row. A
// plane of R rows and C columns takes R + ceil(C/W) - 1 steps of W cells;
// nothing in the DP meets a block barrier, and no diagonal lives in
// shared memory. W is 1, 2 or 4, the least with 32 * W >= C: a strip that
// is a power of two is read from the ring and stored as one vector (on an
// NVIDIA H100, T2 = 96 as 24 lanes of 4 columns took 0.012 ms for 64
// pairs of moves where 32 lanes of 3 columns took 0.018 ms).
//
// The costs do not depend on the DP, so they never wait on it. Each warp
// keeps a ring of rows in shared memory, filled with cp.async (a row of a
// pair is contiguous, so the warp copies it coalesced, 16 bytes a lane
// where base and strides allow, else 4 bytes a lane): at step s each lane
// takes its strip of its row from the ring, a row that landed a step ago
// or earlier; then row s + 1 is waited for and the row s + kPrefetch is
// requested. The prefetch distance is kPrefetch = 8 rows (7 steps from
// request to first use). The read of the ring starts beside the
// shuffle, at the top of the step, and is not part of the chain. The ring
// holds lanes + kPrefetch rows: a row is overwritten only after its last
// reader, the last lane, has read it. The loop is short on purpose: with
// one warp on an SM (a batch of 32 pairs) nothing hides the dispatch of
// a step's operations, a step costs their count, so addresses are kept
// as running offsets and the move of a cell takes two comparisons.
//
// Planes wider than 32 * W columns run in column chunks of 32 * W: a chunk
// goes down all rows, its last column (D, and the chain length where it is
// carried) stays in shared memory, one value per row, and the next chunk's
// lane 0 takes its left neighbour from there instead of from a shuffle.
//
// Each cell is cost + fminf(fminf(diag, up), left) with missing
// neighbours as kBig and 0 at (0, 0), and the move by the comparisons
// diag <= up && diag <= left, else up <= left: the arithmetic and tie
// order of the plain version (ops/dtw.py dtw_costs, moves_from_costs), so
// any schedule gives its bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace dtw_strip {

constexpr float kBig = 1e30f;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kPrefetch = 8;       // rows requested ahead of the wavefront
constexpr int kMaxStrip = 4;       // widest strip (columns per lane)
constexpr int kMaxWarps = 8;       // pairs per block at most
constexpr int kSMs = 132;          // H100 SXM
constexpr size_t kSmemLimit = 232448;  // shared memory a block may opt in to

// The launch geometry of a (B, T1, T2) problem; carry_words is the number
// of 4-byte values per row that a chunk hands to the next (1: D; 2: D and
// the chain length). With move_plane (the path kernel) each warp also
// keeps the int8 moves of its pair, T1 rows of move_pitch bytes, after
// its ring and carry: in shared memory when one warp's share still fits
// a block, else in a global scratch that the caller allocates (B planes
// of T1 * move_pitch bytes). ops/cuda_dtw.py strip_geometry mirrors it.
struct Geometry {
  int strip;          // W: columns per lane
  int chunks;         // column chunks of 32 * W
  int lanes;          // lanes that own a column in the widest chunk
  int pitch;          // floats between two rows of the ring
  int ring_rows;      // rows in a warp's ring
  int warp_floats;    // 4-byte words of shared memory per warp
  int warps;          // pairs (warps) per block
  int blocks;
  int move_pitch;     // bytes between two rows of the move plane (0: none)
  int moves_in_smem;  // 1: the move plane is in shared memory
};

inline Geometry geometry(int B, int T1, int T2, int carry_words,
                         bool move_plane = false) {
  Geometry g;
  // 1, 2 or 4 columns a lane, the least that covers T2 with 32 lanes
  g.strip = T2 <= 32 ? 1 : (T2 <= 64 ? 2 : kMaxStrip);
  const int chunk = 32 * g.strip;
  g.chunks = (T2 + chunk - 1) / chunk;
  const int cols = T2 < chunk ? T2 : chunk;
  g.lanes = (cols + g.strip - 1) / g.strip;
  g.pitch = ((g.lanes * g.strip + 3) / 4) * 4;
  g.ring_rows = g.lanes + kPrefetch;
  g.warp_floats = g.ring_rows * g.pitch +
                  (g.chunks > 1 ? ((T1 * carry_words + 3) / 4) * 4 : 0);
  // a row of moves holds whole strips (a lane stores its W moves as one
  // word) and starts on 4 bytes; the plane ends on 16, like the ring
  g.move_pitch = move_plane ? ((T2 + 3) / 4) * 4 : 0;
  g.moves_in_smem = 0;
  if (move_plane) {
    const size_t plane_floats =
        (static_cast<size_t>(T1) * g.move_pitch / 4 + 3) / 4 * 4;
    if ((g.warp_floats + plane_floats) * 4 <= kSmemLimit) {
      g.warp_floats += static_cast<int>(plane_floats);
      g.moves_in_smem = 1;
    }
  }
  // enough pairs per block that B pairs are resident in one wave, as few
  // as that takes (a small batch spreads over the SMs)
  g.warps = 1;
  while (g.warps < kMaxWarps && g.warps * kSMs < B) g.warps *= 2;
  while (g.warps > 1 &&
         static_cast<size_t>(g.warps) * g.warp_floats * 4 > kSmemLimit)
    g.warps /= 2;
  g.blocks = (B + g.warps - 1) / g.warps;
  return g;
}

inline size_t smem_bytes(const Geometry& g) {
  return static_cast<size_t>(g.warps) * g.warp_floats * 4;
}

inline void geometry_to_ints(const Geometry& g, int* out) {
  out[0] = g.strip;
  out[1] = g.chunks;
  out[2] = g.lanes;
  out[3] = g.pitch;
  out[4] = g.ring_rows;
  out[5] = g.warp_floats;
  out[6] = g.warps;
  out[7] = g.blocks;
  out[8] = g.move_pitch;
  out[9] = g.moves_in_smem;
}

// 16-byte copies need the base and every row start on 16 bytes and whole
// vectors inside a row
inline bool vector_aligned(const void* base, long long batch_stride,
                           long long row_stride, int T2) {
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 &&
         batch_stride % 4 == 0 && row_stride % 4 == 0 && T2 % 4 == 0;
}

// cp.async takes its destination as a 32-bit shared-memory address
__device__ __forceinline__ unsigned shared_address(const void* smem) {
  return static_cast<unsigned>(__cvta_generic_to_shared(smem));
}

__device__ __forceinline__ void cp_async_16(unsigned dst, const float* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(unsigned dst, const float* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// A lane's registers: the previous row of its strip (D, and L where the
// chain length is carried), and the left neighbour of the strip in the
// previous row.
template <int W, bool kLen>
struct Strip {
  float up[W];
  float corner;
  int lup[kLen ? W : 1];
  int lcorner;

  // origin: this lane's first cell is (0, 0), whose best neighbour is 0
  __device__ __forceinline__ void init(bool origin) {
#pragma unroll
    for (int w = 0; w < W; ++w) up[w] = kBig;
    corner = origin ? 0.f : kBig;
#pragma unroll
    for (int w = 0; w < (kLen ? W : 1); ++w) lup[w] = 0;
    lcorner = 0;
  }

  // One row of the strip: cost[] its costs, (left, lleft) the cell left
  // of the strip in this row. Leaves the row in up[] (and lup[]) and
  // returns its moves, one byte per column, the strip's first column
  // lowest. With m = min(diag, up), the plain version's comparisons
  // (diag if diag <= up and diag <= left, else up if up <= left, else
  // left) are: left unless m <= left, then diag if diag <= up, else up.
  __device__ __forceinline__ unsigned row(const float (&cost)[W], float left,
                                          int lleft) {
    float dg = corner;
    int ldg = lcorner;
    corner = left;
    lcorner = lleft;
    unsigned moves = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float u = up[w];
      const bool diag_first = dg <= u;
      const float m = fminf(dg, u);
      const bool not_left = m <= left;
      const float value = cost[w] + fminf(m, left);
      moves |= not_left ? (diag_first ? 3u << (8 * w) : 2u << (8 * w))
                        : 1u << (8 * w);
      if constexpr (kLen) {
        const int lu = lup[w];
        const int len = 1 + (not_left ? (diag_first ? ldg : lu) : lleft);
        ldg = lu;
        lleft = len;
        lup[w] = len;
      }
      dg = u;
      left = value;
      up[w] = value;
    }
    return moves;
  }
};

// A lane's strip of a row, from the ring by its 32-bit shared address
// (the conversion from a generic pointer is made once, outside the loop).
template <int W>
__device__ __forceinline__ void load_strip(unsigned at, float (&cost)[W]) {
  if constexpr (W == 4) {
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(cost[0]), "=f"(cost[1]), "=f"(cost[2]), "=f"(cost[3])
                 : "r"(at)
                 : "memory");
  } else if constexpr (W == 2) {
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                 : "=f"(cost[0]), "=f"(cost[1])
                 : "r"(at)
                 : "memory");
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w)
      asm volatile("ld.shared.f32 %0, [%1];\n"
                   : "=f"(cost[w])
                   : "r"(at + 4 * w)
                   : "memory");
  }
}

// One column chunk of one pair, by one warp. gmem points at (row 0, the
// chunk's first column); rows x cols cells are computed. ring is the
// warp's ring (ring_rows rows of pitch floats); carry_d / carry_l hold one
// value per row: read by lane 0 when has_prev, written by the chunk's last
// lane when has_next (a chunk that has a next one is full: 32 lanes).
// emit(strip, moves) is called by each lane after each row of its strip,
// in the order of the rows; after the call strip holds the last row this
// lane computed. Every lane of the warp must call this function.
//
// The steps come in three runs: while the first rows reach the lanes one
// by one, and again while the last rows leave them, each lane tests
// whether its row is inside the plane; in between every lane that owns a
// column has a row, and the loop body tests nothing. There a lane without
// a column computes on lane 0's costs and keeps the result to itself.
//
// kVec4: the rows are copied 16 bytes a lane (vector_aligned), else 4.
// kCarry: the plane has more than one chunk; a plane of one chunk carries
// nothing and its loop leaves the carry out.
template <int W, bool kLen, bool kVec4, bool kCarry, class Emit>
__device__ __forceinline__ void chunk_forward(
    const float* __restrict__ gmem, long long row_stride, int rows, int cols,
    float* ring, int pitch, int ring_rows, float* carry_d, int* carry_l,
    bool has_prev, bool has_next, bool first_chunk, Strip<W, kLen>& strip,
    Emit&& emit) {
  const int lane = threadIdx.x & 31;
  const int lanes = (cols + W - 1) / W;
  const int steps = rows + lanes - 1;
  const bool owns = lane < lanes;
  const unsigned my_rows = owns ? rows : 0;
  const bool carries_in = kCarry && has_prev && lane == 0;
  const bool carries_out = kCarry && has_next && lane == lanes - 1;
  strip.init(first_chunk && lane == 0);

  // what this lane copies of every row: one 16-byte piece, or the 4-byte
  // elements lane, lane + 32, ... (at most W: a chunk has 32 * W columns)
  const int piece = kVec4 ? 4 * lane : lane;
  const float* src = gmem + piece;
  const unsigned ring_at = shared_address(ring);
  const unsigned pitch_bytes = 4u * pitch;
  const unsigned ring_bytes = ring_rows * pitch_bytes;
  const unsigned fill_begin = ring_at + 4u * piece;
  unsigned fill = fill_begin;  // where the next requested row goes
  auto request = [&]() {
    if constexpr (kVec4) {
      if (piece < cols) cp_async_16(fill, src);
    } else {
#pragma unroll
      for (int k = 0; k < W; ++k)
        if (piece + 32 * k < cols) cp_async_4(fill + 128 * k, src + 32 * k);
    }
  };

  // the ring may still be read by a lane that lags in the chunk before
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kPrefetch; ++r) {
    if (r < rows) request();
    cp_async_commit();
    src += row_stride;
    fill += pitch_bytes;  // ring_rows > kPrefetch: no wrap yet
  }
  cp_async_wait<kPrefetch - 1>();  // row 0
  __syncwarp();

  // this lane's row at the coming step, and the address of its strip of
  // that row in the ring (row r lives in slot r mod ring_rows); a lane
  // without a column follows lane 0
  const int as_lane = owns ? lane : 0;
  int row = -as_lane;
  const unsigned read_begin = ring_at + 4u * (as_lane * W);
  unsigned read = read_begin - as_lane * pitch_bytes;
  int s = 0;

  auto step = [&](auto guarded) {  // std::true_type or std::false_type
    const bool active =
        !decltype(guarded)::value || static_cast<unsigned>(row) < my_rows;
    // the left neighbour first: it is the chain. Every lane shuffles at
    // every step; only the arithmetic is predicated.
    float left = __shfl_up_sync(kFullMask, strip.up[W - 1], 1);
    int lleft = 0;
    if constexpr (kLen)
      lleft = __shfl_up_sync(kFullMask, strip.lup[W - 1], 1);
    // this step's costs, from a row that landed a step ago or earlier
    float cost[W];
    if (active) load_strip<W>(read, cost);
    float carried = kBig;
    int lcarried = 0;
    if constexpr (kCarry) {
      if (carries_in && active) {
        carried = carry_d[row];
        if constexpr (kLen) lcarried = carry_l[row];
      }
    }
    if (lane == 0) {
      left = carried;
      lleft = lcarried;
    }

    // row s + 1 has landed for the next step; request row s + kPrefetch
    // into the slot whose row every lane has read
    cp_async_wait<kPrefetch - 2>();
    __syncwarp();
    if (s + kPrefetch < rows) request();
    cp_async_commit();
    src += row_stride;
    fill += pitch_bytes;
    if (fill == fill_begin + ring_bytes) fill = fill_begin;

    if (active) {
      const unsigned moves = strip.row(cost, left, lleft);
      if (decltype(guarded)::value || owns) emit(strip, moves);
      if constexpr (kCarry) {
        if (carries_out) {
          carry_d[row] = strip.up[W - 1];
          if constexpr (kLen) carry_l[row] = strip.lup[W - 1];
        }
      }
    }
    ++row;
    read += pitch_bytes;
    if (read == read_begin + ring_bytes) read = read_begin;
  };

  const int ramp = min(lanes - 1, steps);
  for (; s < ramp; ++s) step(std::true_type());
#pragma unroll 2
  for (; s < rows; ++s) step(std::false_type());
  for (; s < steps; ++s) step(std::true_type());
  cp_async_wait<0>();
}

}  // namespace dtw_strip
