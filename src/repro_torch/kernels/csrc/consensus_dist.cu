// consensus_dist: the paper's Eq. 7 consensus distances, f32.
//
//     d[k] = sqrt( sum_c (u[k, c] - x[c])^2 )       k < K, c < L
//
// x [L], u [K, L] contiguous row-major f32; d [K].
//
// Replaces the TPU kernel repro/kernels/consensus_dist.py:
// consensus_dist_2d (body _consensus_kernel), reached through
// repro/kernels/ops.py:consensus_dist, which takes the square root. That
// kernel accumulates every grid step into one (K, 1) output block and
// relies on the TPU running its grid in order. A GPU runs its blocks in
// parallel and in no order, so this is a two-pass reduction with no
// atomics, and its result is the same on every run:
//
//   1. partial[k, blk]: block blk (256 threads) sums (u_k - x)^2 over its
//      2,048 columns for each k in turn -- each thread 8 columns, strided
//      by 256 so that neighbouring threads read neighbouring addresses,
//      then a fixed shuffle tree within each warp and across the 8 warps;
//   2. d[k]: one block per k sums row k of partial -- each thread a
//      strided run in order, then the same fixed tree -- and takes the
//      square root.
//
// The plain version (repro_torch/kernels/ref.py:consensus_dist_ref) sums
// in PyTorch's order, so the two agree to float rounding (held to 1e-6
// relative), not bit for bit.
//
// Bound: x and u read once, d written once: (K + 1) L * 4 bytes -- 1.45 GB
// at the DFL path's width (L = 45,228,480, K = 7), 432 us at 3.35 TB/s;
// 3 K L operations (subtract, multiply, add) are far below that. Block blk
// reads x's 8 KB span K times, from L1/L2 after the first. The partials
// are K * L / 2,048 floats (0.6 MB at that width).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kCols = kThreads * kItems;   // ops.CONSENSUS_BLOCK_COLS
constexpr int kWarps = kThreads / 32;

__device__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The block's sum of v in a fixed order; valid in thread 0.
__device__ float block_sum(float v, float* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (warp == 0) {
    s = lane < kWarps ? warp_sums[lane] : 0.f;
    s = warp_sum(s);
  }
  __syncthreads();                     // warp_sums is reused next call
  return s;
}

__global__ void __launch_bounds__(kThreads)
partial_kernel(const float* __restrict__ x, const float* __restrict__ u,
               float* __restrict__ partial, int K, int64_t L) {
  __shared__ float warp_sums[kWarps];
  const int64_t base = (int64_t)blockIdx.x * kCols + threadIdx.x;
  for (int k = 0; k < K; ++k) {
    const float* uk = u + (int64_t)k * L;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int64_t c = base + (int64_t)i * kThreads;
      if (c < L) {
        const float d = uk[c] - x[c];
        acc += d * d;
      }
    }
    const float s = block_sum(acc, warp_sums);
    if (threadIdx.x == 0) partial[(int64_t)k * gridDim.x + blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
final_kernel(const float* __restrict__ partial, float* __restrict__ d,
             int n_blocks) {
  __shared__ float warp_sums[kWarps];
  const float* row = partial + (int64_t)blockIdx.x * n_blocks;
  float acc = 0.f;
  for (int i = threadIdx.x; i < n_blocks; i += kThreads) acc += row[i];
  const float s = block_sum(acc, warp_sums);
  if (threadIdx.x == 0) d[blockIdx.x] = sqrtf(s);
}

}  // namespace

// Launches both passes on `stream`, allocates nothing (partial is the
// caller's [K, ceil(L / 2048)] scratch), and returns cudaGetLastError() as
// an int (0 == success). The caller checks shapes, dtypes and devices;
// K <= 65535.
extern "C" int consensus_dist_f32(const float* x, const float* u,
                                  float* partial, float* d, int K,
                                  int64_t L, void* stream) {
  if (K == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int64_t n_blocks = L > 0 ? (L + kCols - 1) / kCols : 1;
  if (L > 0) {
    partial_kernel<<<(unsigned)n_blocks, kThreads, 0, st>>>(x, u, partial,
                                                            K, L);
  } else {
    cudaMemsetAsync(partial, 0, sizeof(float) * K, st);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  final_kernel<<<K, kThreads, 0, st>>>(partial, d, (int)n_blocks);
  return (int)cudaGetLastError();
}
