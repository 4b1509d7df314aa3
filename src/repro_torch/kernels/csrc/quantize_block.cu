// quantize_block / dequantize_block: the int8 wire codec's round trip on
// a fleet's flat [W, P] f32 rows, one scale per tile.
//
//     scale = max(amax(|x_tile|) / 127, 1e-30)
//     q     = clip(round_half_even(x / scale), -127, 127)      (int8)
//     y     = q * scale
//
// The tile layout is the reference's wire format: a worker's row is read
// as a [rows, cols] matrix with cols = min(1024, P) and zero-padded to
// rows * cols (row_len); a tile is br = min(8, rows) whole rows, i.e. the
// contiguous span [t * tile_len, (t + 1) * tile_len) of the row with
// tile_len = br * cols <= 8192. q is [W, row_len] (its padding is zero),
// scales [W, n_tiles].
//
// Replaces the TPU kernels repro/kernels/quantize_block.py:
// quantize_block_2d (body _quant_kernel) and dequantize_block_2d (body
// _dequant_kernel), which the reference's fused engine vmaps over the W
// workers' [rows, cols] matrices (repro/core/compression.py:qdq_rows).
// The (8, 1024) BlockSpec grid and the zero-padding shim are TPU layout;
// here each (worker, tile) is one contiguous span of the flat row and
// the ragged end at P is masked.
//
// Arithmetic: amax / 127 and x / scale are IEEE divisions (__fdiv_rn, not
// a multiply by a reciprocal), rintf rounds half to even, and the
// dequantize multiply is __fmul_rn, so both kernels are bit-equal to
// their plain versions (repro_torch/kernels/ref.py) and to the
// reference's jnp oracles. A max is exact in any order, so the block
// reduction of amax cannot change a bit.
//
// Bound: quantize reads x once (4 W P bytes) and writes q (W row_len
// bytes) and the scales (4 W n_tiles); dequantize reads q (W P bytes,
// the padding is never read) and the scales and writes y (4 W P). At the
// main path's W = 30, P = 6922 (row_len 7168, one tile per worker) that
// is about 1.05 MB and 1.04 MB, 0.31 us each at the H100's 3.35 TB/s;
// their few operations per element are far below the f32 peak. So bytes
// bound both, and at this size the launch latency dominates.
//
// Design: quantize runs one block per (tile, worker): 256 threads hold up
// to 32 elements each in registers (8192 / 256), so x is read once;
// the block reduces amax with warp shuffles and shared memory, then each
// thread writes its quantized elements and thread 0 the scale.
// Neighbouring threads load neighbouring elements (coalesced). Scalar
// loads: at P = 6922 a row is 27,688 bytes, so rows start 8 bytes off a
// 16-byte boundary for odd w and float4 loads would need a prologue.
// Dequantize is elementwise, one thread per element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 8 * 1024;
constexpr int kPerThread = kMaxTile / kThreads;

__device__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? red[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) {
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    }
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scales, int P, int row_len,
                int tile_len, int n_tiles) {
  __shared__ float red[kThreads / 32];
  const int w = blockIdx.y;
  const int64_t start = (int64_t)blockIdx.x * tile_len;
  const float* xr = x + (int64_t)w * P;
  float v[kPerThread];
  float amax = 0.0f;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int e = threadIdx.x + k * kThreads;
    const int64_t idx = start + e;
    v[k] = (e < tile_len && idx < P) ? xr[idx] : 0.0f;
    amax = fmaxf(amax, fabsf(v[k]));
  }
  amax = block_max(amax, red);
  const float scale = fmaxf(__fdiv_rn(amax, 127.0f), 1e-30f);
  int8_t* qr = q + (int64_t)w * row_len;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int e = threadIdx.x + k * kThreads;
    const int64_t idx = start + e;
    if (e < tile_len && idx < row_len) {
      const float r = rintf(__fdiv_rn(v[k], scale));
      qr[idx] = (int8_t)fminf(fmaxf(r, -127.0f), 127.0f);
    }
  }
  if (threadIdx.x == 0) scales[(int64_t)w * n_tiles + blockIdx.x] = scale;
}

__global__ void dequantize_kernel(const int8_t* __restrict__ q,
                                  const float* __restrict__ scales,
                                  float* __restrict__ y, int P, int row_len,
                                  int tile_len, int n_tiles) {
  const int w = blockIdx.y;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= P) return;
  const float s = scales[(int64_t)w * n_tiles + col / tile_len];
  y[(int64_t)w * P + col] =
      __fmul_rn((float)q[(int64_t)w * row_len + col], s);
}

}  // namespace

// Both launch on `stream`, allocate nothing and return cudaGetLastError()
// as an int (0 == success). The caller checks shapes, dtypes and devices;
// W <= 65535 (grid y), tile_len <= 8192.
extern "C" int quantize_block_f32(const float* x, int8_t* q, float* scales,
                                  int W, int P, int row_len, int tile_len,
                                  int n_tiles, void* stream) {
  if (W == 0 || P == 0) return 0;
  const dim3 grid(n_tiles, W);
  quantize_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, q, scales, P, row_len, tile_len, n_tiles);
  return (int)cudaGetLastError();
}

extern "C" int dequantize_block_f32(const int8_t* q, const float* scales,
                                    float* y, int W, int P, int row_len,
                                    int tile_len, int n_tiles,
                                    void* stream) {
  if (W == 0 || P == 0) return 0;
  const dim3 grid((P + kThreads - 1) / kThreads, W);
  dequantize_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      q, scales, y, P, row_len, tile_len, n_tiles);
  return (int)cudaGetLastError();
}
