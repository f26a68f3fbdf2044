// DTW forward DP for Hopper (sm_90a): the argmin move matrix (int8) or the
// full cost tensor (float32), bound to PyTorch through a plain C interface
// and ctypes (abnet3_torch/ops/cuda_dtw.py).
//
// Replaces two TPU kernels of abnet3_tpu/ops/pallas_dtw.py, which run the
// same forward DP and differ only in what they store:
//   - _dtw_move_kernel (wrapper dtw_moves_pallas): moves 3=diag, 2=up,
//     1=left, for the backtrace walk of the gather path;
//   - _dtw_kernel (wrapper dtw_costs_pallas): the cost tensor D.
// One kernel template, instantiated for each store, computes for every
// pair b over the whole padded (T1, T2) plane (no lengths: the DP flows
// from (0,0) outward, so padding never reaches a valid cell)
//     D[i,j] = dist[i,j] + min(D[i-1,j-1], D[i-1,j], D[i,j-1])
// with missing neighbours counting as BIG = 1e30, D[0,0] = dist[0,0] + 0,
// and the move of each cell by the comparisons of
// ops/dtw.py:moves_from_costs (diag if diag <= up and diag <= left, else
// up if up <= left, else left). On finite inputs that makes row 0 read
// 3 at (0,0) and 1 elsewhere and column 0 read 2 below it, as the TPU
// kernel writes them. Each cell is one float32 add of dist and an exact
// minimum, the arithmetic of the plain PyTorch version (ops/dtw.py
// dtw_costs, by anti-diagonals), so moves and costs equal it bit for bit.
// The TPU kernels' log-doubling prefix sums round differently and are not
// copied.
//
// Design: one thread block per pair, one thread per cell of an
// anti-diagonal (a loop over cells when the diagonal is longer than the
// block). The T1+T2-1 anti-diagonals run as a wavefront with three
// rotating diagonals of D in shared memory (3 * 4 * T2 bytes: 1.5 KB at
// T2 = 128, so every bucket up to T2 = 19,370 fits); each step ends in a
// block-wide barrier. Each cell's result goes straight to global memory.
//
// What bounds it on an H100: the bytes are B*T1*T2*(4 + 1) for moves and
// B*T1*T2*(4 + 4) for costs, 2.6 MB and 4.2 MB at (32, 128, 128), 0.8 and
// 1.3 us at 3.35 TB/s. The real limit is latency: T1+T2-1 dependent steps,
// each ending in a barrier, with only B (about 32 on the gather path)
// blocks on 132 SMs, and anti-diagonal reads and writes that touch one
// element per row (uncoalesced). Several pairs per block and a staged,
// coalesced store of the plane are the later work that attacks it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;

template <bool kStoreCosts>
__global__ void dtw_forward_kernel(const float* __restrict__ dist,
                                   void* __restrict__ out, int T1, int T2) {
  extern __shared__ __align__(16) float diags[];
  const size_t plane = static_cast<size_t>(T1) * T2;
  const size_t base = static_cast<size_t>(blockIdx.x) * plane;
  const float* d = dist + base;

  // diagonal k holds the cells (k - j, j)
  for (int k = 0; k < T1 + T2 - 1; ++k) {
    float* cur = diags + (k % 3) * T2;
    const float* prev1 = diags + ((k + 2) % 3) * T2;  // diagonal k-1
    const float* prev2 = diags + ((k + 1) % 3) * T2;  // diagonal k-2
    const int jlo = max(0, k - T1 + 1);
    const int jhi = min(k, T2 - 1);
    for (int j = jlo + threadIdx.x; j <= jhi; j += blockDim.x) {
      const int i = k - j;
      const size_t cell = static_cast<size_t>(i) * T2 + j;
      const float up = i >= 1 ? prev1[j] : kBig;
      const float left = j >= 1 ? prev1[j - 1] : kBig;
      const float dg = (i >= 1 && j >= 1) ? prev2[j - 1] : kBig;
      const float best = k == 0 ? 0.f : fminf(fminf(dg, up), left);
      const float value = d[cell] + best;
      cur[j] = value;
      if constexpr (kStoreCosts) {
        static_cast<float*>(out)[base + cell] = value;
      } else {
        const bool take_diag = dg <= up && dg <= left;
        const bool take_up = !take_diag && up <= left;
        static_cast<int8_t*>(out)[base + cell] = static_cast<int8_t>(
            ((take_diag || take_up) ? 2 : 0) +
            ((take_diag || !take_up) ? 1 : 0));
      }
    }
    __syncthreads();
  }
}

template <bool kStoreCosts>
int launch(const void* dist, void* out, int B, int T1, int T2,
           void* stream) {
  const size_t smem = 3 * sizeof(float) * static_cast<size_t>(T2);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dtw_forward_kernel<kStoreCosts>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = min(T1, T2);
  threads = ((threads + 31) / 32) * 32;
  threads = max(32, min(threads, 1024));
  dtw_forward_kernel<kStoreCosts>
      <<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(dist), out, T1, T2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dist (B,T1,T2) f32 -> moves (B,T1,T2) int8, both contiguous on the
// device. Launches on `stream`; returns cudaGetLastError().
int dtw_moves_launch(const void* dist, void* moves, int B, int T1, int T2,
                     void* stream) {
  return launch<false>(dist, moves, B, T1, T2, stream);
}

// dist (B,T1,T2) f32 -> costs (B,T1,T2) f32, both contiguous on the
// device. Launches on `stream`; returns cudaGetLastError().
int dtw_costs_launch(const void* dist, void* costs, int B, int T1, int T2,
                     void* stream) {
  return launch<true>(dist, costs, B, T1, T2, stream);
}

}  // extern "C"
