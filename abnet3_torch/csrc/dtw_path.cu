// DTW alignment-path mask for Hopper (sm_90a), bound to PyTorch through a
// plain C interface and ctypes (abnet3_torch/ops/cuda_dtw.py).
//
// Replaces the TPU kernel abnet3_tpu/ops/pallas_dtw.py:_dtw_path_kernel
// (wrapper dtw_path_pallas). It computes the same function, not the same
// blocks: for each pair b, the forward DP
//     D[i,j] = dist[i,j] + min(D[i-1,j], D[i,j-1], D[i-1,j-1])
// with its argmin moves (3=diag, 2=up, 1=left; ties go diag, then up,
// the comparisons of ops/dtw.py:moves_from_costs, missing neighbours
// counting as BIG), then the mask A[b] that is 1 on the cells of the
// backtrace chain from (n1-1, n2-1) to (0, 0) and 0 elsewhere, as the
// plain version's reverse row DP (ops/dtw.py:onpath_from_moves) marks
// them. Each cell is one float32 add of dist and an exact minimum, so the
// masks equal the plain version's bit for bit.
//
// What bounds it on an H100: by the roofline, the bytes, at most
// 2*B*T1*T2*4 (dist in, the mask out; a pair reads only its n1 x n2
// cells): 2.4 MB at (32, 96, 96), 0.7 us at 3.35 TB/s. No schedule comes
// near that: each pair is a chain of n1 + ceil(n2 / W) - 1 dependent
// forward steps (119 at T = 96), then a walk of one dependent step per
// path cell (n1 to n1 + n2 - 1 of them), then n1 row stores, and a batch
// of 32 pairs puts one warp on each of 32 SMs: a step costs what the
// dispatch of its operations, or one shared-memory load, takes for one
// warp.
//
// Design. The forward pass is the strip core of csrc/dtw_strip.cuh (which
// says how), over the pair's n1 x n2 cells only: one warp per pair, lane l
// a strip of W = 1, 2 or 4 columns one row behind lane l-1, the costs
// requested with cp.async 8 rows ahead into the warp's ring, no block
// barrier, column chunks of 128 with a carried column past 128 columns.
// Each lane stores the W moves of each row of its strip as one word (32
// bits at W = 4) into the warp's move plane, row i at i * move_pitch:
// 9 KB at T = 96 beside the ring's 12 KB, in shared memory while one
// warp's share fits a block (up to about 200k cells), else in a global
// scratch the wrapper allocates. The DP flows from (0, 0), so the moves of
// the n1 x n2 cells are those of the full plane.
//
// The backtrace: a DTW path is monotone, so row i holds one run [lo_i,
// hi_i] of it, entered at hi_i (n2-1 in row n1-1); lo_i is the highest
// column j <= hi_i whose move is not left, and the next row is entered at
// lo_i - (move is diag). One lane walks the cells on a running shared
// address and leaves in each row the key 2 lo_i + (move is diag) (the
// run's whole story: hi_{i-1} follows from it); then the warp writes the
// mask row by row from the keys, 16 bytes a lane where T2 % 4 == 0, every
// row independent of the others. The rows from n1 on (all rows when a
// length is outside [1, T]) are zeroed first, while the DP runs, so every
// byte of the mask is written exactly once, coalesced. This reproduces the
// reverse row DP on any moves. A warp-parallel walk (each lane the key of
// its strip of a row, one __reduce_max_sync a row, the row written in the
// same step) was built first and measured slower on the card, also when
// it leaves the row stores to the pass below (0.0217 against 0.0180 ms at
// (32, 96, 96), kernel_bench on an NVIDIA H100 80GB HBM3, 700.00 W): it
// issues a few dozen instructions a row from one warp, where the walk by
// one lane issues ~16 a cell around one shared load, and a path of n1 rows
// has n1 to n1 + n2 - 1 cells.
//
// Measured (python -m abnet3_torch.ops.kernel_bench, this kernel and the
// anti-diagonal kernel it replaces in turns in one process, on an NVIDIA
// H100 80GB HBM3, 700.00 W; device time L2-warm / L2-cold): 0.0181 /
// 0.0189 ms at (32, 96, 96) against 0.0710 / 0.1147 (3.9x less); 0.0136 /
// 0.0141 ms at (64, 64, 64) against 0.0444 / 0.0720 (3.3x). The move
// kernel, the same forward chain of 119 steps, takes 0.0125 ms at
// (64, 96, 96): most of the first figure is the forward pass.

#include "dtw_strip.cuh"

namespace {

using dtw_strip::Geometry;

// A lane's W moves of one row, one byte a column, its first column lowest.
template <int W>
__device__ __forceinline__ void store_moves(uint8_t* at, unsigned moves) {
  if constexpr (W == 4) {
    *reinterpret_cast<uint32_t*>(at) = moves;
  } else if constexpr (W == 2) {
    *reinterpret_cast<uint16_t*>(at) = static_cast<uint16_t>(moves);
  } else {
    *at = static_cast<uint8_t>(moves);
  }
}

// One row of the mask, 1 on [lo, hi] and 0 elsewhere, by the whole warp:
// 16 bytes a lane where rows start on 16 bytes, else 4.
__device__ __forceinline__ void write_row(float* o, int T2, bool vec,
                                          int lo, int hi, int lane) {
  if (vec) {
    for (int col = 4 * lane; col < T2; col += 128) {
      *reinterpret_cast<float4*>(o + col) = make_float4(
          col >= lo && col <= hi ? 1.f : 0.f,
          col + 1 >= lo && col + 1 <= hi ? 1.f : 0.f,
          col + 2 >= lo && col + 2 <= hi ? 1.f : 0.f,
          col + 3 >= lo && col + 3 <= hi ? 1.f : 0.f);
    }
  } else {
    for (int col = lane; col < T2; col += 32)
      o[col] = col >= lo && col <= hi ? 1.f : 0.f;
  }
}

// n zeros from o (a whole number of rows), by the whole warp.
__device__ __forceinline__ void write_zeros(float* o, size_t n, bool vec,
                                            int lane) {
  if (vec) {
    for (size_t k = 4 * lane; k < n; k += 128)
      *reinterpret_cast<float4*>(o + k) = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (size_t k = lane; k < n; k += 32) o[k] = 0.f;
  }
}

// The mask of one pair of lengths (a, c), 1 <= a <= T1, 1 <= c <= T2, by
// one warp: the forward pass into the move plane, the walk by lane 0, then
// rows a-1 .. 0 of o from the walk's keys.
template <int W, bool kVec4, bool kCarry>
__device__ __forceinline__ void pair_path(const float* __restrict__ d, int a,
                                          int c, int T1, int T2, float* ring,
                                          int pitch, int ring_rows,
                                          uint8_t* plane, int move_pitch,
                                          float* o, bool vec_out) {
  const int lane = threadIdx.x & 31;
  constexpr int kChunk = 32 * W;
  float* carry = ring + ring_rows * pitch;
  const int chunks = kCarry ? (c - 1) / kChunk + 1 : 1;

  dtw_strip::Strip<W, false> strip;
  for (int ch = 0; ch < chunks; ++ch) {
    const int col0 = ch * kChunk;
    uint8_t* at = plane + col0 + lane * W;  // this lane's strip, row 0
    dtw_strip::chunk_forward<W, false, kVec4, kCarry>(
        d + col0, T2, a, min(kChunk, c - col0), ring, pitch, ring_rows,
        carry, nullptr, ch > 0, ch + 1 < chunks, ch == 0, strip,
        [&](const dtw_strip::Strip<W, false>&, unsigned moves) {
          store_moves<W>(at, moves);
          at += move_pitch;
        });
  }
  __syncwarp();  // every lane's moves are in the plane

  // the walk, by lane 0, one cell a step on a running address: in
  // row i it goes left from the entry column while the move is left; at
  // the first other move it leaves the row, and the key 2j + (move is
  // diag) of that column replaces the row's first word in the plane (the
  // walk never reads a row it has left). Where the walk leaves the plane
  // in row `stop` > 0 (a run past column 0, or a diagonal move from it;
  // only non-finite costs make such moves), rows 0 .. stop-1 get the key
  // -1: their runs are empty.
  int stop = 0;
  if (lane == 0) {
    int i = a - 1, j = c - 1;
    uint8_t* row = plane + static_cast<size_t>(a - 1) * move_pitch;
    for (;;) {
      const unsigned m = row[j];
      if (m == 1u) {
        if (--j >= 0) continue;
        *reinterpret_cast<int*>(row) = -1;
        break;
      }
      const int diag = m == 3u;
      *reinterpret_cast<int*>(row) = 2 * j + diag;
      j -= diag;
      if (i == 0 || j < 0) break;
      --i;
      row -= move_pitch;
    }
    stop = i;
  }
  stop = __shfl_sync(dtw_strip::kFullMask, stop, 0);
  for (int i = lane; i < stop; i += 32)
    *reinterpret_cast<int*>(plane + static_cast<size_t>(i) * move_pitch) = -1;
  __syncwarp();  // every row's key is in the plane

  // the rows of the mask, independent of each other: row i is [lo_i, hi_i]
  // with lo_i from its key and hi_i from the key of row i+1 (c-1 in the
  // last row)
  if (!kCarry && vec_out) {  // T2 <= 128: one float4 a lane a row at most
    const int col = 4 * lane;
    if (col >= T2) return;
    float* out_at = o + static_cast<size_t>(a - 1) * T2 + col;
    const uint8_t* key_at = plane + static_cast<size_t>(a - 1) * move_pitch;
    int hi = c - 1;
#pragma unroll 4
    for (int i = a - 1; i >= 0; --i) {
      const int k = *reinterpret_cast<const int*>(key_at);
      const int lo = max(k >> 1, 0);
      *reinterpret_cast<float4*>(out_at) = make_float4(
          col >= lo && col <= hi ? 1.f : 0.f,
          col + 1 >= lo && col + 1 <= hi ? 1.f : 0.f,
          col + 2 >= lo && col + 2 <= hi ? 1.f : 0.f,
          col + 3 >= lo && col + 3 <= hi ? 1.f : 0.f);
      hi = (k >> 1) - (k & 1);
      key_at -= move_pitch;
      out_at -= T2;
    }
  } else {
    const uint8_t* key_at = plane + static_cast<size_t>(a - 1) * move_pitch;
    int hi = c - 1;
    for (int i = a - 1; i >= 0; --i) {
      const int k = *reinterpret_cast<const int*>(key_at);
      write_row(o + static_cast<size_t>(i) * T2, T2, vec_out, max(k >> 1, 0),
                hi, lane);
      hi = (k >> 1) - (k & 1);
      key_at -= move_pitch;
    }
  }
}

// One pair per warp. kSmemPlane: the move plane follows the warp's ring
// (and carry) in shared memory, else it is the pair's slice of the global
// scratch. The copy width and the carry are the same for every warp of a
// launch, so the loop is compiled for each and chosen here.
template <int W, bool kSmemPlane>
__global__ void dtw_path_kernel(const float* __restrict__ dist,
                                const int* __restrict__ n1,
                                const int* __restrict__ n2,
                                float* __restrict__ out,
                                uint8_t* __restrict__ moves_global, int B,
                                int T1, int T2, int vec4, int pitch,
                                int ring_rows, int warp_floats,
                                int move_pitch) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the whole warp
  const size_t plane = static_cast<size_t>(T1) * T2;
  float* o = out + b * plane;
  const bool vec_out = T2 % 4 == 0;
  const int a = n1[b], c = n2[b];
  // lengths outside [1, T] select no cell, as in the plain version; the
  // rows the path cannot reach are written first and drain meanwhile
  const bool valid = a >= 1 && a <= T1 && c >= 1 && c <= T2;
  const size_t zero_from = static_cast<size_t>(valid ? a : 0) * T2;
  write_zeros(o + zero_from, plane - zero_from, vec_out, lane);
  if (!valid) return;

  float* ring = smem + static_cast<size_t>(warp) * warp_floats;
  const bool carry = T2 > 32 * W;
  uint8_t* moves;
  if constexpr (kSmemPlane) {
    moves = reinterpret_cast<uint8_t*>(ring + ring_rows * pitch +
                                       (carry ? (T1 + 3) / 4 * 4 : 0));
  } else {
    moves = moves_global + static_cast<size_t>(b) * T1 * move_pitch;
  }
  const float* d = dist + b * plane;
  if (carry) {
    if (vec4)
      pair_path<W, true, true>(d, a, c, T1, T2, ring, pitch, ring_rows,
                               moves, move_pitch, o, vec_out);
    else
      pair_path<W, false, true>(d, a, c, T1, T2, ring, pitch, ring_rows,
                                moves, move_pitch, o, vec_out);
  } else if (vec4) {
    pair_path<W, true, false>(d, a, c, T1, T2, ring, pitch, ring_rows, moves,
                              move_pitch, o, vec_out);
  } else {
    pair_path<W, false, false>(d, a, c, T1, T2, ring, pitch, ring_rows,
                               moves, move_pitch, o, vec_out);
  }
}

template <class Kernel>
int launch_with(Kernel kernel, const Geometry& g, const void* dist,
                const void* n1, const void* n2, void* out, void* moves,
                int B, int T1, int T2, void* stream) {
  const size_t smem = dtw_strip::smem_bytes(g);
  if (smem > dtw_strip::kSmemLimit || (!g.moves_in_smem && moves == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int vec4 = dtw_strip::vector_aligned(
      dist, static_cast<long long>(T1) * T2, T2, T2);
  kernel<<<g.blocks, 32 * g.warps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dist), static_cast<const int*>(n1),
      static_cast<const int*>(n2), static_cast<float*>(out),
      static_cast<uint8_t*>(moves), B, T1, T2, vec4, g.pitch, g.ring_rows,
      g.warp_floats, g.move_pitch);
  return static_cast<int>(cudaGetLastError());
}

Geometry path_geometry(int B, int T1, int T2) {
  return dtw_strip::geometry(B, T1, T2, 1, /*move_plane=*/true);
}

}  // namespace

extern "C" {

// dist (B,T1,T2) f32, n1/n2 (B,) int32, out (B,T1,T2) f32, all contiguous
// on the device; moves is null, or a scratch of B * T1 * move_pitch bytes
// where dtw_path_geometry says the move plane is not in shared memory.
// Launches on `stream`; returns cudaGetLastError(). The strip width and
// the plane's place are chosen from the shape, here and nowhere else.
int dtw_path_launch(const void* dist, const void* n1, const void* n2,
                    void* out, void* moves, int B, int T1, int T2,
                    void* stream) {
  const Geometry g = path_geometry(B, T1, T2);
#define DTW_PATH_LAUNCH(W)                                                  \
  return g.moves_in_smem                                                    \
             ? launch_with(dtw_path_kernel<W, true>, g, dist, n1, n2, out,  \
                           moves, B, T1, T2, stream)                        \
             : launch_with(dtw_path_kernel<W, false>, g, dist, n1, n2, out, \
                           moves, B, T1, T2, stream)
  switch (g.strip) {
    case 1:
      DTW_PATH_LAUNCH(1);
    case 2:
      DTW_PATH_LAUNCH(2);
    default:
      DTW_PATH_LAUNCH(4);
  }
#undef DTW_PATH_LAUNCH
}

// The launch geometry of (B, T1, T2) as 10 ints (dtw_strip::Geometry, in
// the order of its fields), for the tests of its Python mirror.
void dtw_path_geometry(int B, int T1, int T2, int* out) {
  dtw_strip::geometry_to_ints(path_geometry(B, T1, T2), out);
}

}  // extern "C"
