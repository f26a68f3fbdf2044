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
//
// Design: one thread block per pair, one thread per row of an
// anti-diagonal. D and L live on three rotating anti-diagonals in shared
// memory (6*T1*4 bytes, so no shared-memory guard at any T a bank
// holds), and each cell of dist is read from device memory as the
// wavefront reaches it. The DP runs only over the pair's n1 x n2
// sub-grid, so a short pair ends early. dist is read through a batch
// stride and a row stride (its last dimension contiguous), so the (T1, B,
// T2) rows layout of the ABX tiles and the (B, T1, T2) layout of the pair
// stream both launch it without a transposing copy. (Staging each pair's
// plane in shared memory first was measured slower at the tile row: its
// 39 KB per block leave room for 5 blocks per SM where this design keeps
// all 1,024 blocks of a row resident at once.)
// Each cell is one float32 add of dist and an exact minimum, the
// arithmetic of the plain PyTorch version (ops/dtw.py:dtw_costs), so psum
// equals it bit for bit and plen exactly.
//
// What bounds it on an H100: the bytes. At the ABX tile row (T1, B, T2) =
// (96, 1024, 96) the input is 37.7 MB, about 11 us at 3.35 TB/s, against
// about 4 float32 operations per cell (0.6 us at 67 TFLOP/s); a pair of
// lengths (n1, n2) needs only n1*n2 of its cells. The wavefront's
// n1+n2-1 dependent steps, each ending in a block barrier, are the
// latency this simple design pays; several pairs per block and
// warp-synchronous diagonals are the later work that attacks it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;

__global__ void dtw_path_stats_kernel(const float* __restrict__ dist,
                                      long long batch_stride,
                                      long long row_stride,
                                      const int* __restrict__ n1,
                                      const int* __restrict__ n2,
                                      float* __restrict__ psum,
                                      float* __restrict__ plen,
                                      int T1, int T2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int a = n1[b], c = n2[b];
  // lengths outside [1, T] select no cell, as in the plain version
  if (a < 1 || a > T1 || c < 1 || c > T2) {
    if (threadIdx.x == 0) {
      psum[b] = 0.f;
      plen[b] = 0.f;
    }
    return;
  }
  float* fdiag = reinterpret_cast<float*>(smem);
  int* ldiag = reinterpret_cast<int*>(fdiag + 3 * T1);
  const float* d = dist + b * batch_stride;

  // diagonal k holds the cells (i, k - i), indexed by the row i
  const int last = a + c - 2;
  for (int k = 0; k <= last; ++k) {
    float* D = fdiag + (k % 3) * T1;
    const float* D1 = fdiag + ((k + 2) % 3) * T1;  // diagonal k-1
    const float* D2 = fdiag + ((k + 1) % 3) * T1;  // diagonal k-2
    int* L = ldiag + (k % 3) * T1;
    const int* L1 = ldiag + ((k + 2) % 3) * T1;
    const int* L2 = ldiag + ((k + 1) % 3) * T1;
    const int ilo = max(0, k - c + 1);
    const int ihi = min(k, a - 1);
    for (int i = ilo + threadIdx.x; i <= ihi; i += blockDim.x) {
      const int j = k - i;
      const float cost = d[i * row_stride + j];
      float best = 0.f;
      int len = 1;
      if (k > 0) {
        const float up = i >= 1 ? D1[i - 1] : kBig;
        const float left = j >= 1 ? D1[i] : kBig;
        const float dg = (i >= 1 && j >= 1) ? D2[i - 1] : kBig;
        const bool take_diag = dg <= up && dg <= left;
        const bool take_up = !take_diag && up <= left;
        best = fminf(fminf(dg, up), left);
        len = 1 + (take_diag ? L2[i - 1] : (take_up ? L1[i - 1] : L1[i]));
      }
      const float v = cost + best;
      D[i] = v;
      L[i] = len;
      if (k == last) {  // the one cell (a-1, c-1)
        psum[b] = v;
        plen[b] = static_cast<float>(len);
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Shared memory a launch of (T1, T2) needs.
size_t dtw_path_stats_smem_bytes(int T1, int T2) {
  return 6 * sizeof(float) * static_cast<size_t>(T1);
}

// dist: B pairs of (T1, T2) float32 planes on the device, element
// (b, i, j) at dist + b*batch_stride + i*row_stride + j; n1/n2 (B,)
// int32; psum/plen (B,) float32. Launches on `stream`; returns
// cudaGetLastError().
int dtw_path_stats_launch(const void* dist, long long batch_stride,
                          long long row_stride, const void* n1,
                          const void* n2, void* psum, void* plen, int B,
                          int T1, int T2, void* stream) {
  const size_t smem = dtw_path_stats_smem_bytes(T1, T2);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dtw_path_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = min(T1, T2);
  threads = ((threads + 31) / 32) * 32;
  threads = max(32, min(threads, 1024));
  dtw_path_stats_kernel<<<B, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dist), batch_stride, row_stride,
      static_cast<const int*>(n1), static_cast<const int*>(n2),
      static_cast<float*>(psum), static_cast<float*>(plen), T1, T2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
