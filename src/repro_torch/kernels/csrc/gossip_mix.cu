// gossip_mix: the paper's Eq. 5 mixing step for a whole fleet, f32.
//
//     y[b, :] = x[b, :] + sum_{k=0..K-1} w[b, k] * (u[k, :] - x[b, :])
//
// x [B, L], u [K, L], w [B, K], y [B, L], all contiguous row-major f32.
// The fused round engine calls it once per round with B = K = W workers,
// u = x (every row a neighbour buffer) and w the round's mixing matrix;
// AD-PSGD's pairwise average is the B = K = 1, w = 0.5 case, and both
// endpoints' rows in one launch the B = K = 2 case.
//
// Replaces the TPU kernel repro/kernels/gossip_mix.py:gossip_mix_2d
// (body _gossip_kernel, called at :45), which the reference's fused scan
// vmaps over the W workers (repro/core/fused.py:286-289). The (8, 1024)
// tiling and the zero-padding shim of that kernel are TPU layout, not
// semantics: here the flat [W, P] rows are used as they are and the
// ragged edge of L is masked.
//
// Arithmetic order: acc = x[b], then acc = acc + w * (u - x) for k
// ascending, each step rounded separately (__fsub_rn / __fmul_rn /
// __fadd_rn keep nvcc from contracting it into an FMA). The result is
// bit-equal to the plain PyTorch loop (repro_torch/kernels/ref.py:
// gossip_mix_ref), and an identity row of w (a round without
// communication) is an exact no-op.
//
// Bound: the function reads x, u and w once and writes y once,
// (2 B L + K L + B K) * 4 bytes; where u is x, x's bytes are read once.
// At the MLP path's B = K = 30, L = 6,922 that is 1.66 MB, 0.50 us at
// the H100's 3.35 TB/s, under the few microseconds a launch itself
// takes on the device; at the registry path's B = K = 8, L = 45,228,480
// (u = x) it is 2.9 GB, 0.87 ms. Its 3 B K L operations (a subtract, a
// multiply and an add, which may not be fused) take 0.26 ms there at the
// 67 TFLOP/s f32 rate, so bytes bound it at every shape.
//
// What held the first design back: one block per (output row, 256
// columns), each thread walking k and loading u[k] itself, so the grid
// read u once per output row -- B times in all, 30 times from L2 on the
// MLP path and 8 times from HBM at the registry width, where blockIdx.x
// swept all of u once per output row -- and each thread's K loads waited
// on one another.
//
// Design: one block of 128 threads per (tile of 128 columns, group of R
// output rows); thread i owns column i of the tile for all R rows, with
// R accumulators and its R values of x in registers. The block stages
// u[k, tile] for a chunk of up to 64 k in shared memory with 4-byte
// cp.async, all of the chunk's copies in flight at once (a row of L =
// 6,922 floats is not 16-byte aligned; the warp's 4-byte copies coalesce
// into whole lines), and w[group rows, chunk] k-major, so a k's R weights
// are read as 16-byte broadcasts; then it adds the chunk's k in ascending
// order. Any K runs in chunks. u is read ceil(B / R) times instead of B
// times. R is B rounded up to a power of two, at most 32, halved while
// the grid would not fill the card's SMs once (down to 4): R = 8 at the
// MLP path (4 groups of 55 tiles), R = 8 at the registry width (one
// group: u read once), R = 1 for AD-PSGD. Where u is x (the same
// pointer, B = K <= 64) the rows of x come from the staged tile too, so
// the registry width reads x once from HBM and writes y once: the byte
// bound's traffic.
//
// At the MLP path's shape the kernel is held back by neither bytes nor
// operations: a launch of it takes about 2.9 us of device time at B = K
// = 1, and the 3 B K L rounded operations take 0.56 us of all 132 SMs'
// FP32 lanes. Staging in groups computed on arrival, smaller row groups,
// one u tile shared by four row groups, and 64- or 256-column tiles were
// each measured slower on an H100 (PERF.md, Findings).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;     // columns a block, one a thread
constexpr int kChunk = 64;     // rows of u staged a pass
constexpr int kMaxRows = 32;   // output rows a block, at most
constexpr int kMinRows = 4;    // ... and at least, where B allows

// 4-byte asynchronous copy global -> shared; src_bytes 0 zero-fills
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int R>
__global__ void __launch_bounds__(kCols)
gossip_mix_kernel(const float* __restrict__ x, const float* __restrict__ u,
                  const float* __restrict__ w, float* __restrict__ y, int B,
                  int K, int L, int alias) {
  extern __shared__ float smem[];
  const int kc_max = min(K, kChunk);
  float* su = smem;                    // [kc_max][kCols]
  float* sw = su + kc_max * kCols;     // [kc][R]: a k's R weights together
  const int tid = threadIdx.x;
  const int col = blockIdx.x * kCols + tid;
  const bool live = col < L;
  const int64_t src_col = live ? col : L - 1;   // an address in bounds
  const int b0 = blockIdx.y * R;

  float xv[R], acc[R];
  if (!alias) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int b = b0 + r;
      xv[r] = (live && b < B) ? x[(int64_t)b * L + col] : 0.f;
      acc[r] = xv[r];
    }
  }
  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int kc = min(kChunk, K - k0);
    if (k0) __syncthreads();           // the last chunk's readers are done
    for (int k = 0; k < kc; ++k) {
      cp_async4(su + k * kCols + tid, u + (int64_t)(k0 + k) * L + src_col,
                live ? 4 : 0);
    }
    for (int i = tid; i < kc * R; i += kCols) {
      const int b = b0 + i % R;
      sw[i] = b < B ? w[(int64_t)b * K + k0 + i / R] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();
    if (alias && k0 == 0) {            // u is x: x's rows are in the tile
#pragma unroll
      for (int r = 0; r < R; ++r) {
        xv[r] = b0 + r < B ? su[(b0 + r) * kCols + tid] : 0.f;
        acc[r] = xv[r];
      }
    }
#pragma unroll 4
    for (int k = 0; k < kc; ++k) {
      const float uv = su[k * kCols + tid];
      float wk[R];                     // broadcast reads, 16 bytes a load
      if constexpr (R % 4 == 0) {
#pragma unroll
        for (int j = 0; j < R / 4; ++j) {
          const float4 w4 = reinterpret_cast<const float4*>(sw + k * R)[j];
          wk[4 * j] = w4.x;
          wk[4 * j + 1] = w4.y;
          wk[4 * j + 2] = w4.z;
          wk[4 * j + 3] = w4.w;
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) wk[r] = sw[k * R + r];
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[r] = __fadd_rn(acc[r], __fmul_rn(wk[r], __fsub_rn(uv, xv[r])));
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (b0 + r < B) y[(int64_t)(b0 + r) * L + col] = acc[r];
  }
}

int num_sms() {
  static int sms = 0;                  // once per process
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      sms = 132;
    }
  }
  return sms;
}

template <int R>
int launch(const float* x, const float* u, const float* w, float* y, int B,
           int K, int L, int alias, cudaStream_t stream) {
  const dim3 grid((L + kCols - 1) / kCols, (B + R - 1) / R);
  const size_t smem =
      (size_t)(min(K, kChunk) * kCols + R * min(K, kChunk)) * sizeof(float);
  gossip_mix_kernel<R><<<grid, kCols, smem, stream>>>(x, u, w, y, B, K, L,
                                                      alias);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`, allocates nothing, and returns cudaGetLastError()
// as an int (0 == success). The caller checks shapes, dtypes and
// devices; B <= 65535 (the row groups on grid y) and L < 2**31.
extern "C" int gossip_mix_f32(const float* x, const float* u, const float* w,
                              float* y, int B, int K, int L, void* stream) {
  if (B == 0 || L == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int64_t tiles = (L + kCols - 1) / kCols;
  int rows = 1;
  while (rows < B && rows < kMaxRows) rows <<= 1;
  while (rows > kMinRows && tiles * ((B + rows - 1) / rows) < num_sms()) {
    rows >>= 1;
  }
  const int alias = x == u && B == K && K <= kChunk;
  switch (rows) {
    case 1: return launch<1>(x, u, w, y, B, K, L, alias, st);
    case 2: return launch<2>(x, u, w, y, B, K, L, alias, st);
    case 4: return launch<4>(x, u, w, y, B, K, L, alias, st);
    case 8: return launch<8>(x, u, w, y, B, K, L, alias, st);
    case 16: return launch<16>(x, u, w, y, B, K, L, alias, st);
    default: return launch<32>(x, u, w, y, B, K, L, alias, st);
  }
}

// cudaGetErrorString for the codes the launchers return.
extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
