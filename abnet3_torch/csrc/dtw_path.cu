// DTW alignment-path mask for Hopper (sm_90a), bound to PyTorch through a
// plain C interface and ctypes (abnet3_torch/ops/cuda_dtw.py).
//
// Replaces the TPU kernel abnet3_tpu/ops/pallas_dtw.py:_dtw_path_kernel
// (wrapper dtw_path_pallas). It computes the same function, not the same
// blocks: for each pair b, the forward DP
//     D[i,j] = dist[i,j] + min(D[i-1,j], D[i,j-1], D[i-1,j-1])
// with its argmin moves (3=diag, 2=up, 1=left; ties go diag, then up,
// exactly the comparisons of ops/dtw.py:moves_from_costs, missing
// neighbours counting as BIG), then the mask A[b] that is 1 on the cells
// the backtrace from (n1-1, n2-1) to (0,0) visits and 0 elsewhere.
//
// Design: one thread block per pair, one thread per column of an
// anti-diagonal (a loop over columns when the diagonal is longer than the
// block). The forward pass walks the T1+T2-1 anti-diagonals as a
// wavefront, keeping three rolling diagonals of D in shared memory, and
// stores the int8 moves in shared memory (T1*T2 bytes: 9,216 at T=96) or,
// when they do not fit beside the diagonals, in a global scratch the
// wrapper allocates. Meanwhile all threads zero the pair's output plane
// with coalesced writes; after a barrier one thread walks the moves back
// from the endpoint and writes the 1.0 cells (at most T1+T2-1 reads).
// Each cell is one float32 add of dist and an exact minimum, so the masks
// equal the plain PyTorch version's (ops/dtw.py:dtw_costs, which runs the
// same recurrence) bit for bit.
//
// What bounds it on an H100: the bytes are 2*B*T1*T2*4 (dist in, mask
// out), 2.4 MB at B=32, T=96, about 0.7 us at 3.35 TB/s. The real limit is
// latency: T1+T2-1 dependent wavefront steps, each ending in a block-wide
// barrier, plus the sequential walk, with only B (about 32 on the flagship
// path) blocks on 132 SMs. Several pairs per block, warp-synchronous
// diagonals and a persistent grid are the later work that attacks it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;

__global__ void dtw_path_kernel(const float* __restrict__ dist,
                                const int* __restrict__ n1,
                                const int* __restrict__ n2,
                                float* __restrict__ out,
                                int8_t* __restrict__ moves_global,
                                int T1, int T2) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* diag_buf[3] = {reinterpret_cast<float*>(smem),
                        reinterpret_cast<float*>(smem) + T2,
                        reinterpret_cast<float*>(smem) + 2 * T2};
  const size_t plane = static_cast<size_t>(T1) * T2;
  const int b = blockIdx.x;
  int8_t* mv = moves_global != nullptr
                   ? moves_global + b * plane
                   : reinterpret_cast<int8_t*>(smem + 3 * sizeof(float) * T2);
  const float* d = dist + b * plane;
  float* o = out + b * plane;

  for (size_t idx = threadIdx.x; idx < plane; idx += blockDim.x) o[idx] = 0.f;

  // forward wavefront: diagonal k holds the cells (k - j, j)
  for (int k = 0; k < T1 + T2 - 1; ++k) {
    float* cur = diag_buf[k % 3];
    const float* prev1 = diag_buf[(k + 2) % 3];  // diagonal k-1
    const float* prev2 = diag_buf[(k + 1) % 3];  // diagonal k-2
    const int jlo = max(0, k - T1 + 1);
    const int jhi = min(k, T2 - 1);
    for (int j = jlo + threadIdx.x; j <= jhi; j += blockDim.x) {
      const int i = k - j;
      const float up = i >= 1 ? prev1[j] : kBig;
      const float left = j >= 1 ? prev1[j - 1] : kBig;
      const float dg = (i >= 1 && j >= 1) ? prev2[j - 1] : kBig;
      const bool take_diag = dg <= up && dg <= left;
      const bool take_up = !take_diag && up <= left;
      mv[i * T2 + j] = static_cast<int8_t>(
          ((take_diag || take_up) ? 2 : 0) + ((take_diag || !take_up) ? 1 : 0));
      const float best = k == 0 ? 0.f : fminf(fminf(dg, up), left);
      cur[j] = d[i * T2 + j] + best;
    }
    __syncthreads();
  }

  // backtrace walk; lengths outside [1, T] mark nothing, as in the plain
  // version (ops/dtw.py:onpath_from_moves)
  if (threadIdx.x == 0) {
    const int a = n1[b], c = n2[b];
    if (a >= 1 && a <= T1 && c >= 1 && c <= T2) {
      int i = a - 1, j = c - 1;
      for (int s = 0; s < T1 + T2 - 1; ++s) {
        o[i * T2 + j] = 1.f;
        if (i == 0 && j == 0) break;
        const int m = mv[i * T2 + j];
        i = max(i - (m >= 2 ? 1 : 0), 0);
        j = max(j - (m & 1), 0);
      }
    }
  }
}

}  // namespace

extern "C" {

// Shared memory a launch of (T1, T2) needs, moves included or not.
size_t dtw_path_smem_bytes(int T1, int T2, int moves_in_smem) {
  size_t bytes = 3 * sizeof(float) * static_cast<size_t>(T2);
  if (moves_in_smem) bytes += static_cast<size_t>(T1) * T2;
  return bytes;
}

// dist (B,T1,T2) f32, n1/n2 (B,) int32, out (B,T1,T2) f32, all on the
// device; moves is a (B,T1,T2) int8 scratch or null to keep the moves in
// shared memory. Launches on `stream`; returns cudaGetLastError().
int dtw_path_launch(const void* dist, const void* n1, const void* n2,
                    void* out, void* moves, int B, int T1, int T2,
                    void* stream) {
  const size_t smem = dtw_path_smem_bytes(T1, T2, moves == nullptr);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dtw_path_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = min(T1, T2);
  threads = ((threads + 31) / 32) * 32;
  threads = max(32, min(threads, 1024));
  dtw_path_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dist), static_cast<const int*>(n1),
      static_cast<const int*>(n2), static_cast<float*>(out),
      static_cast<int8_t*>(moves), T1, T2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
