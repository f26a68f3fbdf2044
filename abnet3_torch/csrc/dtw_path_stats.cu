// DTW path statistics for Hopper (sm_90a), bound to PyTorch through a
// plain C interface and ctypes (abnet3_torch/ops/cuda_dtw.py).
//
// Replaces the TPU kernel abnet3_tpu/ops/pallas_dtw.py:_make_stats_kernel
// (wrappers dtw_path_stats_rows_pallas and dtw_path_stats_pallas). It
// computes the same function, not the same blocks: for each pair b, the
// forward DP
//     D[i,j] = dist[i,j] + min(D[i-1,j], D[i,j-1], D[i-1,j-1])
// carrying the length of the argmin chain,
//     L[i,j] = 1 + L[pred],  pred = diag if diag <= up && diag <= left,
//                                   else up if up <= left, else left
// (the tie order of ops/dtw.py:moves_from_costs, missing neighbours
// counting as BIG), and returns psum[b] = D[n1-1, n2-1], the sum of dist
// along the backtrace path, and plen[b] = L[n1-1, n2-1], its length.
// Nothing of size T1*T2 is written: no cost tensor, no moves, no mask.
// Each cell is one float32 add of dist and an exact minimum, the
// arithmetic of the plain PyTorch version (ops/dtw.py:dtw_costs), so psum
// equals it bit for bit and plen exactly.
//
// What bounds it on an H100: the bytes. At the ABX tile row (T1, B, T2) =
// (96, 1024, 96) the input is 37.7 MB, about 11 us at 3.35 TB/s, against
// about 4 float32 operations per cell (0.6 us at 67 TFLOP/s); a pair of
// lengths (n1, n2) needs only n1*n2 of its cells, and only those are
// read. Beside the bytes stands the chain: n1 + ceil(n2 / W) - 1
// dependent steps of W cells and one two-value shuffle each; with 8 warps
// on an SM the steps of the warps overlap, and what is left is the
// dispatch of their operations. The anti-diagonal kernel it replaces paid
// n1 + n2 - 1 block barriers with a trip to device memory inside each.
//
// Design (the warp core is csrc/dtw_strip.cuh, which says how): one warp
// per pair and no block barrier; lane l owns W = 1, 2 or 4 neighbouring
// columns (the least with 32 * W >= T2) and runs one row behind lane l-1,
// D and L of its left neighbour arriving by __shfl_up_sync; the costs are
// requested with cp.async kPrefetch = 8 rows ahead of the wavefront into
// a per-warp ring of rows in shared memory (lanes + 8 rows, 12 KB at T2 =
// 96: not the whole plane, so 8 pairs fit a block and a row of 1,024 pairs
// is resident in one wave), so no step of the chain waits on device
// memory.
// The DP runs over the pair's n1 x n2 cells only; the lane that owns
// column n2-1 holds the result after its last row, n1-1, and writes it
// when the warp leaves the loop. A warp whose pair has lengths outside
// [1, T] writes (0, 0) and leaves as a whole. dist is read through a
// batch stride and a row stride (its last dimension contiguous), so the
// (T1, B, T2) rows layout of the ABX tiles and the (B, T1, T2) layout of
// the pair stream both launch it without a transposing copy; a view whose
// base or strides are not multiples of 16 bytes is copied 4 bytes a lane
// instead of 16, with the same bits. Planes wider than 128 columns run in
// column chunks of 128, D and L of a chunk's last column carried in
// shared memory (8 bytes a row), which takes every T1 up to about 26,000
// and any T2.

#include "dtw_strip.cuh"

namespace {

using dtw_strip::Geometry;

// The statistics of one pair of lengths (a, c), by one warp.
template <int W, bool kVec4, bool kCarry>
__device__ __forceinline__ void pair_stats(const float* __restrict__ d,
                                           long long row_stride, int a, int c,
                                           float* ring, int pitch,
                                           int ring_rows, int T1,
                                           float* __restrict__ psum,
                                           float* __restrict__ plen) {
  const int lane = threadIdx.x & 31;
  float* carry_d = ring + ring_rows * pitch;
  int* carry_l = reinterpret_cast<int*>(carry_d + T1);
  constexpr int kChunk = 32 * W;
  const int chunks = (c - 1) / kChunk + 1;  // up to the result's column

  dtw_strip::Strip<W, true> strip;
  for (int ch = 0; ch < chunks; ++ch) {
    const int col0 = ch * kChunk;
    dtw_strip::chunk_forward<W, true, kVec4, kCarry>(
        d + col0, row_stride, a, min(kChunk, c - col0), ring, pitch,
        ring_rows, carry_d, carry_l, ch > 0, ch + 1 < chunks, ch == 0, strip,
        [](const dtw_strip::Strip<W, true>&, unsigned) {});
  }
  // the lane that owns column c-1 computed row a-1 last and holds it
  const int at = c - 1 - (chunks - 1) * kChunk - lane * W;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    if (w == at) {
      *psum = strip.up[w];
      *plen = static_cast<float>(strip.lup[w]);
    }
  }
}

// One pair per warp. The copy width and the carry are the same for every
// warp of a launch, so the loop is compiled for each and chosen here.
template <int W>
__global__ void dtw_path_stats_kernel(const float* __restrict__ dist,
                                      long long batch_stride,
                                      long long row_stride,
                                      const int* __restrict__ n1,
                                      const int* __restrict__ n2,
                                      float* __restrict__ psum,
                                      float* __restrict__ plen, int B, int T1,
                                      int T2, int vec4, int pitch,
                                      int ring_rows, int warp_floats) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the whole warp
  const int a = n1[b], c = n2[b];
  // lengths outside [1, T] select no cell, as in the plain version
  if (a < 1 || a > T1 || c < 1 || c > T2) {
    if (lane == 0) {
      psum[b] = 0.f;
      plen[b] = 0.f;
    }
    return;
  }
  float* ring = smem + static_cast<size_t>(warp) * warp_floats;
  const float* d = dist + b * batch_stride;
  if (T2 > 32 * W) {
    if (vec4)
      pair_stats<W, true, true>(d, row_stride, a, c, ring, pitch, ring_rows,
                                T1, psum + b, plen + b);
    else
      pair_stats<W, false, true>(d, row_stride, a, c, ring, pitch, ring_rows,
                                 T1, psum + b, plen + b);
  } else if (vec4) {
    pair_stats<W, true, false>(d, row_stride, a, c, ring, pitch, ring_rows,
                               T1, psum + b, plen + b);
  } else {
    pair_stats<W, false, false>(d, row_stride, a, c, ring, pitch, ring_rows,
                                T1, psum + b, plen + b);
  }
}

template <class Kernel>
int launch_with(Kernel kernel, const Geometry& g, const void* dist,
                long long batch_stride, long long row_stride, const void* n1,
                const void* n2, void* psum, void* plen, int B, int T1,
                int T2, void* stream) {
  const size_t smem = dtw_strip::smem_bytes(g);
  if (smem > dtw_strip::kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int vec4 =
      dtw_strip::vector_aligned(dist, batch_stride, row_stride, T2);
  kernel<<<g.blocks, 32 * g.warps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dist), batch_stride, row_stride,
      static_cast<const int*>(n1), static_cast<const int*>(n2),
      static_cast<float*>(psum), static_cast<float*>(plen), B, T1, T2, vec4,
      g.pitch, g.ring_rows, g.warp_floats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dist: B pairs of (T1, T2) float32 planes on the device, element
// (b, i, j) at dist + b*batch_stride + i*row_stride + j; n1/n2 (B,)
// int32; psum/plen (B,) float32. Launches on `stream`; returns
// cudaGetLastError(). The strip width is chosen from the shape, here and
// nowhere else.
int dtw_path_stats_launch(const void* dist, long long batch_stride,
                          long long row_stride, const void* n1,
                          const void* n2, void* psum, void* plen, int B,
                          int T1, int T2, void* stream) {
  const Geometry g = dtw_strip::geometry(B, T1, T2, 2);
#define DTW_STATS_LAUNCH(W)                                                  \
  return launch_with(dtw_path_stats_kernel<W>, g, dist, batch_stride,        \
                     row_stride, n1, n2, psum, plen, B, T1, T2, stream)
  switch (g.strip) {
    case 1:
      DTW_STATS_LAUNCH(1);
    case 2:
      DTW_STATS_LAUNCH(2);
    default:
      DTW_STATS_LAUNCH(4);
  }
#undef DTW_STATS_LAUNCH
}

// The launch geometry of (B, T1, T2) as 10 ints (dtw_strip::Geometry, in
// the order of its fields), for the tests of its Python mirror.
void dtw_path_stats_geometry(int B, int T1, int T2, int* out) {
  dtw_strip::geometry_to_ints(dtw_strip::geometry(B, T1, T2, 2), out);
}

}  // extern "C"
