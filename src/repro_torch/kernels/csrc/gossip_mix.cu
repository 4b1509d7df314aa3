// gossip_mix: the paper's Eq. 5 mixing step for a whole fleet, f32.
//
//     y[b, :] = x[b, :] + sum_{k=0..K-1} w[b, k] * (u[k, :] - x[b, :])
//
// x [B, L], u [K, L], w [B, K], y [B, L], all contiguous row-major f32.
// The fused round engine calls it once per round with B = K = W workers,
// u = x (every row a neighbour buffer) and w the round's mixing matrix;
// AD-PSGD's pairwise average is the B = K = 1, w = 0.5 case.
//
// Replaces the TPU kernel repro/kernels/gossip_mix.py:gossip_mix_2d
// (body _gossip_kernel), which the reference's fused scan vmaps over the
// W workers (repro/core/fused.py:286-289). The (8, 1024) tiling and the
// zero-padding shim of that kernel are TPU layout, not semantics: here
// the flat [W, P] rows are used as they are and the ragged edge of L is
// masked.
//
// Arithmetic order: acc = acc + w * (u - x) for k ascending, each step
// rounded separately (__fsub_rn / __fmul_rn / __fadd_rn keep nvcc from
// contracting it into an FMA). The result is then bit-equal to the plain
// PyTorch loop (repro_torch/kernels/ref.py:gossip_mix_ref), and an
// identity row of w (a round without communication) is an exact no-op.
//
// Bound: the function reads x, u and w once and writes y once,
// (2 B L + K L + B K) * 4 bytes. On the main path u is x, so it reads
// x once: (2 B L + B K) * 4 bytes -- about 1.66 MB at B = K = 30,
// L = 6922, which is 0.50 us at the H100's 3.35 TB/s; its
// 3 B K L = 18.7 MFLOP (subtract, multiply, add) take 0.28 us at the
// 67 TFLOP/s f32 peak. So bytes bound it, and at this size the launch
// latency (a few us) dominates both.
//
// Design: one block per (output row b, chunk of 256 columns). The block
// stages w[b, :] in shared memory and loops over k; neighbouring threads
// load neighbouring columns, so every load of a u row is coalesced.
// Scalar loads: at P = 6922 a row is 27,688 bytes, not a multiple of 16,
// so float4 loads would need a ragged prologue. Each u row is read once
// per output row (B times in all, from L2 at this size). A later version
// could read each column tile of u once for all B output rows -- one
// block per column tile holding B accumulators -- cutting u traffic by B.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void gossip_mix_kernel(const float* __restrict__ x,
                                  const float* __restrict__ u,
                                  const float* __restrict__ w,
                                  float* __restrict__ y, int K, int L) {
  extern __shared__ float w_row[];
  const int b = blockIdx.y;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    w_row[k] = w[(int64_t)b * K + k];
  }
  __syncthreads();
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= L) return;
  const float xv = x[(int64_t)b * L + col];
  float acc = xv;
  for (int k = 0; k < K; ++k) {
    const float d = __fsub_rn(u[(int64_t)k * L + col], xv);
    acc = __fadd_rn(acc, __fmul_rn(w_row[k], d));
  }
  y[(int64_t)b * L + col] = acc;
}

}  // namespace

// Launches on `stream`, allocates nothing, and returns cudaGetLastError()
// as an int (0 == success). The caller checks shapes, dtypes and devices;
// B <= 65535 (grid y) and K * 4 bytes <= 48 KB (static shared limit).
extern "C" int gossip_mix_f32(const float* x, const float* u, const float* w,
                              float* y, int B, int K, int L, void* stream) {
  if (B == 0 || L == 0) return 0;
  const dim3 grid((L + kThreads - 1) / kThreads, B);
  const size_t smem = (size_t)K * sizeof(float);
  gossip_mix_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, u, w, y, K, L);
  return (int)cudaGetLastError();
}

// cudaGetErrorString for the codes the launchers return.
extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
