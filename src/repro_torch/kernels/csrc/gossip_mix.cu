// gossip_mix: the paper's Eq. 5 mixing step for a whole fleet, f32.
//
//     y[b, :] = x[b, :] + sum_{k=0..K-1} w[b, k] * (u[k mod U, :] - c[b, :])
//
// x [B, L], c [B, L], u [U, L], w [B, K], y [B, L], all contiguous
// row-major f32, K a multiple of U. The centre c is x itself (the same
// pointer) in every call but the compressed matching gossip's, where the
// accumulator starts at the parameters x while each term takes the
// difference of the decoded payloads (repro/runtime/collectives.py:
// 192-197). K = U but for the matching gossip, which lays its M matchings
// out matching-major over the W rows (K = M W, U = W): column m W + j
// weights row j for matching m, so the terms are added in the
// reference's matching order without copying the rows M times.
// The fused round engine calls it once per round with B = K = W workers,
// u = x (every row a neighbour buffer) and w the round's mixing matrix;
// AD-PSGD's pairwise average is the B = K = 1, w = 0.5 case, and both
// endpoints' rows in one launch the B = K = 2 case.
//
// The lane-strided form (gossip_mix_lanes_f32) runs S independent such
// mixes in one launch, for the fused engines' batched seeds axis: x
// [S, B, L], u [S, K, L], y [S, B, L] contiguous, w [S, B, K] with each
// lane's [B, K] contiguous and a lane stride of its own (0: one mixing
// matrix shared by every lane). The lane is the grid's z axis; a lane's
// blocks do exactly what one launch of the single form does, so the
// result is bit-equal to S launches of it. K is not folded into S K
// neighbours: each lane keeps its own K.
//
// Replaces the TPU kernel repro/kernels/gossip_mix.py:gossip_mix_2d
// (body _gossip_kernel, called at :45), which the reference's fused scan
// vmaps over the W workers (repro/core/fused.py:286-289). The (8, 1024)
// tiling and the zero-padding shim of that kernel are TPU layout, not
// semantics: here the flat [W, P] rows are used as they are and the
// ragged edge of L is masked.
//
// Arithmetic order: acc = x[b], then acc = acc + w * (u - c) for k
// ascending, each step rounded separately (__fsub_rn / __fmul_rn /
// __fadd_rn keep nvcc from contracting it into an FMA). The result is
// bit-equal to the plain PyTorch loop (repro_torch/kernels/ref.py:
// gossip_mix_ref), and an identity row of w (a round without
// communication) is an exact no-op.
//
// The bf16-rounded form (gossip_mix_bf16round_f32) keeps the f32
// storage and rounds as the reference's matching gossip does on a bf16
// leaf (repro/runtime/collectives.py:84-87 and 192-197, acc + (w * (y -
// x)).astype(bf16) in bf16): each term w * (u - c) is rounded to bf16 (to nearest
// even) before it is added, and every sum after it. With x's entries
// bf16 values, a zero weight still adds an exact nothing. It is the
// single form's arithmetic with two more roundings a step, so the same
// design and bound.
//
// Bound: the function reads x, c, u and w once and writes y once,
// (3 B L + U L + B K) * 4 bytes less each operand that is another's
// pointer: where c and u are x, (2 B L + B K) * 4.
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
// group: u read once), R = 1 for AD-PSGD. Where c is u (the same
// pointer, B = U <= min(K, 64)) the rows of c come from the staged tile
// too, so the registry width, where c and u are x, reads x once from HBM
// and writes y once: the byte bound's traffic. Where K > U (the matching
// layout) the block stages u's U rows once and column k reads staged row
// k mod U (staging each chunk's u[k mod U] afresh, 8 of 12 rows repeats,
// took 11.9 ms at the trainer's [4, 361,821,120], K = 12, on an H100).
// Staged once, the bf16-rounded form takes 9.65 ms there against its
// 3.46 ms byte bound: 9 of a row's 12 columns are zero weights, and each
// still pays its subtract, multiply and two bf16 roundings (conversions
// run at 16 a clock an SM), which bound the call before its bytes do.
//
// At the MLP path's shape the kernel is held back by neither bytes nor
// operations: a launch of it takes about 2.9 us of device time at B = K
// = 1, and the 3 B K L rounded operations take 0.56 us of all 132 SMs'
// FP32 lanes. Staging in groups computed on arrival, smaller row groups,
// one u tile shared by four row groups, and 64- or 256-column tiles were
// each measured slower on an H100 (PERF.md, Findings).

#include <cuda_bf16.h>
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

// v rounded to the nearest bf16 (ties to even), as an f32
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int R, bool RoundBf16>
__global__ void __launch_bounds__(kCols)
gossip_mix_kernel(const float* __restrict__ x, const float* __restrict__ c,
                  const float* __restrict__ u, const float* __restrict__ w,
                  float* __restrict__ y, int B, int U, int K, int L,
                  int c_tile, int x_is_c, int64_t w_lane_stride) {
  extern __shared__ float smem[];
  const int64_t lane = blockIdx.z;     // 0 in the single form
  x += lane * B * (int64_t)L;
  c += lane * B * (int64_t)L;
  u += lane * U * (int64_t)L;
  y += lane * B * (int64_t)L;
  w += lane * w_lane_stride;
  // K > U (the matching layout): u's U rows are staged once and column
  // k reads row k mod U; else a chunk stages its own kc rows
  const bool cyclic = K > U;
  const int kc_max = min(K, kChunk);
  float* su = smem;                    // [cyclic ? U : kc_max][kCols]
  float* sw = su + (cyclic ? U : kc_max) * kCols;   // [kc][R]: a k's R
                                                    // weights together
  const int tid = threadIdx.x;
  const int col = blockIdx.x * kCols + tid;
  const bool live = col < L;
  const int64_t src_col = live ? col : L - 1;   // an address in bounds
  const int b0 = blockIdx.y * R;

  float cv[R], acc[R];
  if (!c_tile) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int b = b0 + r;
      cv[r] = (live && b < B) ? c[(int64_t)b * L + col] : 0.f;
      acc[r] = cv[r];
    }
  }
  if (!x_is_c) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int b = b0 + r;
      acc[r] = (live && b < B) ? x[(int64_t)b * L + col] : 0.f;
    }
  }
  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int kc = min(kChunk, K - k0);
    if (k0) __syncthreads();           // the last chunk's readers are done
    if (!cyclic || k0 == 0) {
      for (int k = 0; k < (cyclic ? U : kc); ++k) {
        cp_async4(su + k * kCols + tid,
                  u + (int64_t)(cyclic ? k : k0 + k) * L + src_col,
                  live ? 4 : 0);
      }
    }
    for (int i = tid; i < kc * R; i += kCols) {
      const int b = b0 + i % R;
      sw[i] = b < B ? w[(int64_t)b * K + k0 + i / R] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();
    if (c_tile && k0 == 0) {           // c is u: c's rows are in the tile
#pragma unroll
      for (int r = 0; r < R; ++r) {
        cv[r] = b0 + r < B ? su[(b0 + r) * kCols + tid] : 0.f;
        if (x_is_c) acc[r] = cv[r];
      }
    }
    int row = cyclic ? k0 % U : 0;     // u's staged row of column k0 + k
#pragma unroll 4
    for (int k = 0; k < kc; ++k) {
      const float uv = su[row * kCols + tid];
      row = cyclic ? (row + 1 == U ? 0 : row + 1) : row + 1;
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
        if constexpr (RoundBf16) {
          acc[r] = round_bf16(__fadd_rn(
              acc[r], round_bf16(__fmul_rn(wk[r], __fsub_rn(uv, cv[r])))));
        } else {
          acc[r] = __fadd_rn(acc[r], __fmul_rn(wk[r], __fsub_rn(uv, cv[r])));
        }
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

template <int R, bool RoundBf16>
int launch(const float* x, const float* c, const float* u, const float* w,
           float* y, int S, int B, int U, int K, int L, int c_tile,
           int x_is_c, int64_t w_lane_stride, cudaStream_t stream) {
  const dim3 grid((L + kCols - 1) / kCols, (B + R - 1) / R, S);
  const int staged = K > U ? U : min(K, kChunk);
  const size_t smem =
      (size_t)(staged * kCols + R * min(K, kChunk)) * sizeof(float);
  gossip_mix_kernel<R, RoundBf16><<<grid, kCols, smem, stream>>>(
      x, c, u, w, y, B, U, K, L, c_tile, x_is_c, w_lane_stride);
  return (int)cudaGetLastError();
}

template <bool RoundBf16 = false>
int launch_lanes(const float* x, const float* c, const float* u,
                 const float* w, float* y, int S, int B, int U, int K, int L,
                 int64_t w_lane_stride, cudaStream_t st) {
  if (S == 0 || B == 0 || L == 0) return 0;
  const int64_t tiles = (L + kCols - 1) / kCols;
  int rows = 1;
  while (rows < B && rows < kMaxRows) rows <<= 1;
  while (rows > kMinRows &&
         tiles * ((B + rows - 1) / rows) * S < num_sms()) {
    rows >>= 1;
  }
  const int c_tile = c == u && B == U && B <= min(K, kChunk);
  const int x_is_c = x == c;
  constexpr bool rb = RoundBf16;
#define GOSSIP_MIX_LAUNCH(R_)                                              \
  return launch<R_, rb>(x, c, u, w, y, S, B, U, K, L, c_tile, x_is_c,      \
                        w_lane_stride, st)
  switch (rows) {
    case 1: GOSSIP_MIX_LAUNCH(1);
    case 2: GOSSIP_MIX_LAUNCH(2);
    case 4: GOSSIP_MIX_LAUNCH(4);
    case 8: GOSSIP_MIX_LAUNCH(8);
    case 16: GOSSIP_MIX_LAUNCH(16);
    default: GOSSIP_MIX_LAUNCH(32);
  }
#undef GOSSIP_MIX_LAUNCH
}

}  // namespace

// Launches on `stream`, allocates nothing, and returns cudaGetLastError()
// as an int (0 == success). c may be x and u may be x or c (the same
// pointers); K a multiple of U, and U <= 64 where K > U (u's rows are
// staged whole). The caller checks shapes, dtypes and devices; B <= 65535
// (the row groups on grid y) and L < 2**31.
extern "C" int gossip_mix_f32(const float* x, const float* c, const float* u,
                              const float* w, float* y, int B, int U, int K,
                              int L, void* stream) {
  return launch_lanes(x, c, u, w, y, 1, B, U, K, L, 0, (cudaStream_t)stream);
}

// The bf16-rounded single form: each term and each sum rounded to bf16
// (kept in f32 storage); x's entries should be bf16 values. The same
// return and checks as gossip_mix_f32.
extern "C" int gossip_mix_bf16round_f32(const float* x, const float* c,
                                        const float* u, const float* w,
                                        float* y, int B, int U, int K, int L,
                                        void* stream) {
  return launch_lanes<true>(x, c, u, w, y, 1, B, U, K, L, 0,
                            (cudaStream_t)stream);
}

// The lane-strided form: S <= 65535 lanes (grid z) of the single form
// with c = x and U = K, x [S, B, L], u [S, K, L], y [S, B, L]
// contiguous; lane s's w at w + s * w_lane_stride. The same return and
// checks as gossip_mix_f32.
extern "C" int gossip_mix_lanes_f32(const float* x, const float* u,
                                    const float* w, float* y, int S, int B,
                                    int K, int L, int64_t w_lane_stride,
                                    void* stream) {
  return launch_lanes(x, x, u, w, y, S, B, K, K, L, w_lane_stride,
                      (cudaStream_t)stream);
}

// cudaGetErrorString for the codes the launchers return.
extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
