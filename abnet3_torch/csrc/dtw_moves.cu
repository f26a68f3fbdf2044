// DTW forward DP for Hopper (sm_90a): the argmin move matrix (int8) or the
// full cost tensor (float32); and the walk of a move matrix into index
// paths (its own note, further down). Bound to PyTorch through a plain C
// interface and ctypes (abnet3_torch/ops/cuda_dtw.py).
//
// Replaces two TPU kernels of abnet3_tpu/ops/pallas_dtw.py, which run the
// same forward DP and differ only in what they store:
//   - _dtw_move_kernel (wrapper dtw_moves_pallas): moves 3=diag, 2=up,
//     1=left, for the backtrace walk of the gather path;
//   - _dtw_kernel (wrapper dtw_costs_pallas): the cost tensor D.
// Both compute, for every pair b over the whole padded (T1, T2) plane (no
// lengths: the DP flows from (0,0) outward, so padding never reaches a
// valid cell)
//     D[i,j] = dist[i,j] + min(D[i-1,j-1], D[i-1,j], D[i,j-1])
// with missing neighbours counting as BIG = 1e30, D[0,0] = dist[0,0] + 0,
// and the move of each cell by the comparisons of
// ops/dtw.py:moves_from_costs (diag if diag <= up and diag <= left, else
// up if up <= left, else left). On finite inputs that makes row 0 read
// 3 at (0,0) and 1 elsewhere and column 0 read 2 below it, as the TPU
// kernel writes them. Each cell is one float32 add of dist and an exact
// minimum, the arithmetic of the plain PyTorch version (ops/dtw.py
// dtw_costs), so moves and costs equal it bit for bit. The TPU kernels'
// log-doubling prefix sums round differently and are not copied.
//
// What bounds it on an H100: by the roofline, the bytes: B*T1*T2*(4 + 1)
// for moves and B*T1*T2*(4 + 4) for costs, 2.6 MB and 4.2 MB at
// (32, 128, 128), 0.8 and 1.3 us at 3.35 TB/s. No schedule reaches that:
// the DP is a chain of dependent steps, and a batch of 32 pairs puts one
// warp on each of 32 SMs. The floor of this design is the chain: T1 +
// lanes - 1 steps (159 at T = 128), each costing what the dispatch of
// its operations takes from one warp. The anti-diagonal kernel it replaces
// paid T1 + T2 - 1 block barriers with a trip to device memory inside
// each.
//
// Design (the warp core is csrc/dtw_strip.cuh, which says how): one warp
// per pair and no block barrier; lane l owns W = 1, 2 or 4 neighbouring
// columns (the least with 32 * W >= T2) and runs one row behind lane l-1,
// its left neighbour arriving by __shfl_up_sync; the costs are requested
// with cp.async kPrefetch = 8 rows ahead of the wavefront into a per-warp
// ring of rows in shared memory, so no step of the chain waits on device
// memory; a lane stores the W moves of its row as one 32-bit (W = 4) or
// 16-bit (W = 2) word and its W costs as one vector where T2 is a
// multiple of W, else element by element. A block holds as many pairs as
// it takes for the batch to be resident in one wave (one at B <= 132, so
// that a small batch spreads over the SMs; up to 8). Planes wider than
// 128 columns run in column chunks of 128, the last column of a chunk
// carried in shared memory (T1 floats), which takes every T1 up to about
// 52,000 and any T2.

#include "dtw_strip.cuh"

namespace {

using dtw_strip::Geometry;

// The forward DP of one pair per warp; kStoreCosts picks the store.
template <int W, bool kStoreCosts, bool kVec4, bool kCarry>
__device__ __forceinline__ void forward_pair(const float* __restrict__ dist,
                                             void* __restrict__ out, int b,
                                             int T1, int T2, int chunks,
                                             float* ring, int pitch,
                                             int ring_rows) {
  using Out = typename std::conditional<kStoreCosts, float, int8_t>::type;
  const int lane = threadIdx.x & 31;
  float* carry = ring + ring_rows * pitch;
  const size_t base = static_cast<size_t>(b) * T1 * T2;
  constexpr int kChunk = 32 * W;
  const bool packed = T2 % W == 0;  // whole strips only, aligned stores

  for (int ch = 0; ch < chunks; ++ch) {
    const int col0 = ch * kChunk;
    const int cols = min(kChunk, T2 - col0);
    const int first = lane * W;
    // this lane's strip in the row it stores next
    Out* o = static_cast<Out*>(out) + base + col0 + first;
    dtw_strip::Strip<W, false> state;
    dtw_strip::chunk_forward<W, false, kVec4, kCarry>(
        dist + base + col0, T2, T1, cols, ring, pitch, ring_rows, carry,
        nullptr, ch > 0, ch + 1 < chunks, ch == 0, state,
        [&](const dtw_strip::Strip<W, false>& strip, unsigned moves) {
          Out* at = o;
          o += T2;
          if constexpr (kStoreCosts) {
            if constexpr (W == 4) {
              if (packed) {
                *reinterpret_cast<float4*>(at) = make_float4(
                    strip.up[0], strip.up[1], strip.up[2], strip.up[3]);
                return;
              }
            } else if constexpr (W == 2) {
              if (packed) {
                *reinterpret_cast<float2*>(at) =
                    make_float2(strip.up[0], strip.up[1]);
                return;
              }
            }
#pragma unroll
            for (int w = 0; w < W; ++w)
              if (first + w < cols) at[w] = strip.up[w];
          } else {
            if constexpr (W == 4) {
              if (packed) {
                *reinterpret_cast<uint32_t*>(at) = moves;
                return;
              }
            } else if constexpr (W == 2) {
              if (packed) {
                *reinterpret_cast<uint16_t*>(at) =
                    static_cast<uint16_t>(moves);
                return;
              }
            }
#pragma unroll
            for (int w = 0; w < W; ++w)
              if (first + w < cols)
                at[w] = static_cast<int8_t>((moves >> (8 * w)) & 0xff);
          }
        });
  }
}

// One pair per warp. The copy width and the carry are the same for every
// warp of a launch, so the loop is compiled for each and chosen here.
template <int W, bool kStoreCosts>
__device__ __forceinline__ void forward_pairs(const float* __restrict__ dist,
                                              void* __restrict__ out, int B,
                                              int T1, int T2, bool vec4,
                                              int chunks, int pitch,
                                              int ring_rows,
                                              int warp_floats) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the whole warp
  float* ring = smem + static_cast<size_t>(warp) * warp_floats;
  if (chunks > 1) {
    if (vec4)
      forward_pair<W, kStoreCosts, true, true>(dist, out, b, T1, T2, chunks,
                                               ring, pitch, ring_rows);
    else
      forward_pair<W, kStoreCosts, false, true>(dist, out, b, T1, T2, chunks,
                                                ring, pitch, ring_rows);
  } else if (vec4) {
    forward_pair<W, kStoreCosts, true, false>(dist, out, b, T1, T2, 1, ring,
                                              pitch, ring_rows);
  } else {
    forward_pair<W, kStoreCosts, false, false>(dist, out, b, T1, T2, 1, ring,
                                               pitch, ring_rows);
  }
}

template <int W>
__global__ void dtw_moves_kernel(const float* __restrict__ dist,
                                 int8_t* __restrict__ moves, int B, int T1,
                                 int T2, int vec4, int chunks, int pitch,
                                 int ring_rows, int warp_floats) {
  forward_pairs<W, false>(dist, moves, B, T1, T2, vec4 != 0, chunks, pitch,
                          ring_rows, warp_floats);
}

template <int W>
__global__ void dtw_costs_kernel(const float* __restrict__ dist,
                                 float* __restrict__ costs, int B, int T1,
                                 int T2, int vec4, int chunks, int pitch,
                                 int ring_rows, int warp_floats) {
  forward_pairs<W, true>(dist, costs, B, T1, T2, vec4 != 0, chunks, pitch,
                         ring_rows, warp_floats);
}

template <class Out, class Kernel>
int launch_with(Kernel kernel, const Geometry& g, const void* dist, void* out,
                int B, int T1, int T2, void* stream) {
  const size_t smem = dtw_strip::smem_bytes(g);
  if (smem > dtw_strip::kSmemLimit)
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
      static_cast<const float*>(dist), static_cast<Out*>(out), B, T1, T2,
      vec4, g.chunks, g.pitch, g.ring_rows, g.warp_floats);
  return static_cast<int>(cudaGetLastError());
}

// The strip width is chosen from the shape, here and nowhere else.
#define DTW_STRIP_DISPATCH(Out, kernel)                                     \
  switch (g.strip) {                                                        \
    case 1:                                                                 \
      return launch_with<Out>(kernel<1>, g, dist, out, B, T1, T2, stream);  \
    case 2:                                                                 \
      return launch_with<Out>(kernel<2>, g, dist, out, B, T1, T2, stream);  \
    default:                                                                \
      return launch_with<Out>(kernel<4>, g, dist, out, B, T1, T2, stream);  \
  }

int launch_moves(const void* dist, void* out, int B, int T1, int T2,
                 void* stream) {
  const Geometry g = dtw_strip::geometry(B, T1, T2, 1);
  DTW_STRIP_DISPATCH(int8_t, dtw_moves_kernel)
}

int launch_costs(const void* dist, void* out, int B, int T1, int T2,
                 void* stream) {
  const Geometry g = dtw_strip::geometry(B, T1, T2, 1);
  DTW_STRIP_DISPATCH(float, dtw_costs_kernel)
}

#undef DTW_STRIP_DISPATCH

// ---------------------------------------------------------------------------
// The walk of a move plane into index paths (walk_moves_launch).
//
// Replaces no Pallas kernel: the JAX package walks the moves with a
// lax.scan (abnet3_tpu/ops/dtw.py:walk_moves, the scan at :229), which the
// port ran as a Python loop of L = T1 + T2 - 1 steps of about 8 launches
// each (ops/dtw.py walk_moves_plain, the plain version, kept). For each
// pair b it gives what that loop gives: the walk starts at (n1-1, n2-1)
// and runs L steps; a move code m steps back by (m >> 1, m & 1), each
// coordinate clamped at 0, so (0, 0) absorbs it; path_len = L - (steps at
// (0, 0)) + 1, which is L + 1 for a walk that never reaches it; and
// path1/path2[t] is the step at clamp(path_len - 1 - t, 0, L - 1): the
// path in increasing order, the endpoint repeated past path_len.
//
// What bounds it on an H100: not the bytes (the plane, B*T1*T2 int8, is
// 1 MiB at (64, 128, 128), 0.3 us at 3.35 TB/s; the paths, 2*B*L int64,
// 255 KiB) but the walk, a chain of dependent loads: each step loads the
// move that the next step's address depends on, path_len steps a pair
// (at most L = 255 at T = 128).
//
// Design: one warp per pair, as many pairs a block as the strip kernels
// take (a batch of 64 is 64 blocks of one warp, one wave). The warp
// stages the rows the walk can visit, rows 0 .. n1-1 (one contiguous span
// of the plane), into shared memory with cp.async, 16 bytes a lane where
// the span starts on 16 bytes (every power-of-two bucket of 4 and more),
// else a byte a lane; so a step of the chain is a shared-memory load (~30
// cycles) and not a trip to L2. Lane 0 walks and keeps the trail as
// 32-bit words i << 16 | j in shared memory after the rows; it stops at
// (0, 0), since the rest of the trail would be (0, 0) again. Then the 32
// lanes write path1 and path2 in increasing order, coalesced, from the
// trail. Where the rows and the trail do not fit a block's shared memory
// (past ~230k cells, such as (1024, 1024)) the same code walks the plane
// in place in global memory, the trail alone in shared memory; a trail
// past the shared memory (L > 58,112) is refused. The moves are read as
// unsigned bytes: for the codes 0..127 that is the loop's arithmetic; a
// negative code, which no kernel writes, steps back by its byte's value
// and the walk stays in the plane (the loop's gather would leave it).
// Lengths are clamped into [1, T] (there too the loop would leave it).

// the bytes of a warp's staged rows (the whole plane at most) and of its
// trail (L words), each ending on 16
__host__ __device__ inline size_t walk_plane_bytes(int T1, int T2) {
  return (static_cast<size_t>(T1) * T2 + 15) / 16 * 16;
}

__host__ __device__ inline size_t walk_trail_bytes(int T1, int T2) {
  return (static_cast<size_t>(T1 + T2 - 1) * 4 + 15) / 16 * 16;
}

// n bytes from global to shared memory (dst on 16 bytes) by one warp:
// every 16-byte copy requested before the first is waited for
__device__ __forceinline__ void stage_rows(uint8_t* dst,
                                           const uint8_t* __restrict__ src,
                                           size_t n, int lane) {
  size_t done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const unsigned base = dtw_strip::shared_address(dst);
    const size_t vectors = n / 16;
    for (size_t v = lane; v < vectors; v += 32)
      dtw_strip::cp_async_16(base + static_cast<unsigned>(16 * v),
                             reinterpret_cast<const float*>(src + 16 * v));
    dtw_strip::cp_async_commit();
    done = 16 * vectors;
  }
#pragma unroll 4
  for (size_t k = done + lane; k < n; k += 32) dst[k] = __ldg(src + k);
  dtw_strip::cp_async_wait<0>();
  __syncwarp();
}

template <bool kStaged>
__global__ void walk_moves_kernel(const uint8_t* __restrict__ moves,
                                  const int* __restrict__ n1,
                                  const int* __restrict__ n2,
                                  long long* __restrict__ path1,
                                  long long* __restrict__ path2,
                                  long long* __restrict__ path_len, int B,
                                  int T1, int T2, int warp_bytes) {
  extern __shared__ __align__(16) uint8_t walk_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the whole warp
  const int L = T1 + T2 - 1;
  const int i0 = min(max(n1[b], 1), T1) - 1;
  const int j0 = min(max(n2[b], 1), T2) - 1;
  uint8_t* mine = walk_smem + static_cast<size_t>(warp) * warp_bytes;
  const uint8_t* plane = moves + static_cast<size_t>(b) * T1 * T2;
  unsigned* trail = reinterpret_cast<unsigned*>(mine);
  if constexpr (kStaged) {
    stage_rows(mine, plane, static_cast<size_t>(i0 + 1) * T2, lane);
    plane = mine;
    trail = reinterpret_cast<unsigned*>(mine + walk_plane_bytes(T1, T2));
  }

  // the walk, by lane 0; i * T2 + j < T1 * T2 < 2^30 where the trail fits
  int len = 0;
  if (lane == 0) {
    int i = i0, j = j0, s = 0;
    for (;;) {
      trail[s] = (static_cast<unsigned>(i) << 16) | static_cast<unsigned>(j);
      if ((i | j) == 0) {
        len = s + 1;
        break;
      }
      if (++s == L) {
        len = L + 1;
        break;
      }
      unsigned m;
      if constexpr (kStaged)
        m = plane[i * T2 + j];
      else
        m = __ldg(plane + i * T2 + j);
      i = max(i - static_cast<int>(m >> 1), 0);
      j = max(j - static_cast<int>(m & 1u), 0);
    }
  }
  len = __shfl_sync(dtw_strip::kFullMask, len, 0);
  __syncwarp();  // the trail is in shared memory

  const size_t row = static_cast<size_t>(b) * L;
  for (int t = lane; t < L; t += 32) {
    const unsigned c = trail[min(max(len - 1 - t, 0), L - 1)];
    path1[row + t] = static_cast<long long>(c >> 16);
    path2[row + t] = static_cast<long long>(c & 0xffffu);
  }
  if (lane == 0) path_len[b] = len;
}

int launch_walk(const void* moves, const void* n1, const void* n2,
                void* path1, void* path2, void* path_len, int B, int T1,
                int T2, void* stream) {
  const size_t trail = walk_trail_bytes(T1, T2);
  const size_t staged = walk_plane_bytes(T1, T2) + trail;
  const bool in_smem = staged <= dtw_strip::kSmemLimit;
  const size_t warp_bytes = in_smem ? staged : trail;
  if (warp_bytes > dtw_strip::kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  int warps = 1;
  while (warps < dtw_strip::kMaxWarps && warps * dtw_strip::kSMs < B)
    warps *= 2;
  while (warps > 1 && warps * warp_bytes > dtw_strip::kSmemLimit) warps /= 2;
  const size_t smem = warps * warp_bytes;
  auto kernel = in_smem ? &walk_moves_kernel<true> : &walk_moves_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<(B + warps - 1) / warps, 32 * warps, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(moves), static_cast<const int*>(n1),
      static_cast<const int*>(n2), static_cast<long long*>(path1),
      static_cast<long long*>(path2), static_cast<long long*>(path_len), B,
      T1, T2, static_cast<int>(warp_bytes));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dist (B,T1,T2) f32 -> moves (B,T1,T2) int8, both contiguous on the
// device. Launches on `stream`; returns cudaGetLastError().
int dtw_moves_launch(const void* dist, void* moves, int B, int T1, int T2,
                     void* stream) {
  return launch_moves(dist, moves, B, T1, T2, stream);
}

// dist (B,T1,T2) f32 -> costs (B,T1,T2) f32, both contiguous on the
// device. Launches on `stream`; returns cudaGetLastError().
int dtw_costs_launch(const void* dist, void* costs, int B, int T1, int T2,
                     void* stream) {
  return launch_costs(dist, costs, B, T1, T2, stream);
}

// moves (B,T1,T2) int8, n1/n2 (B,) int32 -> path1, path2 (B, T1+T2-1)
// int64 and path_len (B,) int64, all contiguous on the device. Launches on
// `stream`; returns cudaGetLastError() (cudaErrorInvalidValue for a trail
// past the shared memory).
int walk_moves_launch(const void* moves, const void* n1, const void* n2,
                      void* path1, void* path2, void* path_len, int B,
                      int T1, int T2, void* stream) {
  return launch_walk(moves, n1, n2, path1, path2, path_len, B, T1, T2,
                     stream);
}

// The launch geometry of (B, T1, T2) as 10 ints (dtw_strip::Geometry, in
// the order of its fields), for the tests of its Python mirror.
void dtw_moves_geometry(int B, int T1, int T2, int* out) {
  dtw_strip::geometry_to_ints(dtw_strip::geometry(B, T1, T2, 1), out);
}

}  // extern "C"
