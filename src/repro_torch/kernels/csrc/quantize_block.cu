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
// Design: quantize spreads a tile over a thread-block cluster of S
// blocks (S = 1, 2, 4 or 8, chosen by the wrapper from the grid:
// ops.quantize_cluster), so that a fleet of few tiles -- 30 at the main
// path's [30, 6922], 2 at AD-PSGD's [2, 6922] -- still runs on many SMs;
// one block a tile left each thread 28 IEEE divisions and byte stores on
// one SM while the rest of the card idled. Block r of a cluster takes the
// r-th of S equal spans of the tile (a multiple of 4 elements), 4
// consecutive elements a thread in registers, so x is read once: by 16-
// or 8-byte loads where the row's address allows (P = 6,922 rows start
// on 8 bytes only), else by scalar loads, masked at P. The block reduces
// its amax with warp shuffles and shared memory and leaves it in its
// shared memory; after a cluster barrier every block reads the S partial
// maxima through distributed shared memory, one lane of its first warp
// each (a max is exact in any order, so the scale keeps its bits),
// arrives at a second barrier and quantizes its span, writing q four
// bytes at a time where the address allows (rows of P < 1,024 bytes
// start anywhere) and bytewise elsewhere; it waits at that barrier
// before it exits, so no block's shared memory goes while another can
// still read it. Block 0 of the
// cluster writes the scale. A cluster the card refuses is an error the
// wrapper raises; there is no launch without clusters to fall back to.
//
// Dequantize is a vector pass: a thread takes V = 4 consecutive codes of
// one worker's row (a block 128 threads, 512 codes: 14 blocks a row at P
// = 6,922), reads them with one 4-byte load where the address allows
// (every row where P >= 1,024, whose rows are whole multiples of 1,024
// bytes, if q's base does), finds its tile once (V codes never straddle
// two tiles; no division where a row is one tile) and stores the 4
// products with one 16-byte store where y's row allows, two 8-byte ones
// where it starts on 8 bytes (P = 6,922: every other row), four 4-byte
// ones otherwise; a row of q off 4 bytes and the ragged end at P take a
// loop of single codes, kept out of line. The codes become floats by
// integer operations on the float's bits, not a conversion instruction.
// The first version took one thread an element, a byte load and a
// division by the tile length each. 8 and 16 codes a thread were slower
// (their stores strided across a warp), 256 threads a block 4% faster at
// [30, 6922] and 2% slower at [1, 6922]; issuing the codes' load first
// and converting without the conversion unit took 2% off [2, 6922]
// (tools/kernel_ab.py). At these sizes a launch is most of the time
// (chip_smoke.py's launch_floor_us).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 8 * 1024;
constexpr int kGroups = kMaxTile / (4 * kThreads);   // of 4 elements, S = 1
constexpr int kMaxCluster = 8;
// dequantize: codes a thread (one 4-byte load), threads a block
constexpr int kDequantCodes = 4;
constexpr int kDequantThreads = 128;

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

// a relaxed arrival: it orders no memory access (the caller has its
// remote reads' values in registers already), and a release arrival of
// every thread costs about half a microsecond more here
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ int8_t code(float v, float scale) {
  const float r = rintf(__fdiv_rn(v, scale));
  return (int8_t)fminf(fmaxf(r, -127.0f), 127.0f);
}

// grid (n_tiles * S, W), clusters of (S, 1, 1); span: the elements of a
// tile a block takes, a multiple of 4
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scales, int P, int row_len,
                int tile_len, int n_tiles, int S, int span) {
  __shared__ float red[kThreads / 32];
  const int w = blockIdx.y;
  const int rank = blockIdx.x % S;     // the block's rank in its cluster
  const int tile = blockIdx.x / S;
  const int64_t start = (int64_t)tile * tile_len;
  const int lo = rank * span, hi = min(lo + span, tile_len);
  // the block's first element; every group starts 16 bytes of x (4 of
  // q) further on, so one test of each pointer serves the block
  const float* xs = x + (int64_t)w * P + start + lo;
  int8_t* qs = q + (int64_t)w * row_len + start + lo;
  const bool x16 = ((uintptr_t)xs & 15) == 0;
  const bool x8 = ((uintptr_t)xs & 7) == 0;
  const bool q4 = ((uintptr_t)qs & 3) == 0;
  // elements of this block at or past P (of x) and row_len (of q)
  const int64_t x_end = P - (start + lo), q_end = row_len - (start + lo);
  float4 v[kGroups];
  float amax = 0.0f;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int e = 4 * (threadIdx.x + g * kThreads);   // from lo
    v[g] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (lo + e < hi) {
      if (e + 3 < x_end && x16) {
        v[g] = *reinterpret_cast<const float4*>(xs + e);
      } else if (e + 3 < x_end && x8) {
        const float2 a = *reinterpret_cast<const float2*>(xs + e);
        const float2 b = *reinterpret_cast<const float2*>(xs + e + 2);
        v[g] = make_float4(a.x, a.y, b.x, b.y);
      } else {
        if (e < x_end) v[g].x = xs[e];
        if (e + 1 < x_end) v[g].y = xs[e + 1];
        if (e + 2 < x_end) v[g].z = xs[e + 2];
        if (e + 3 < x_end) v[g].w = xs[e + 3];
      }
    }
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v[g].x), fabsf(v[g].y)),
                             fmaxf(fabsf(v[g].z), fabsf(v[g].w))));
  }
  amax = block_max(amax, red);
  if (S > 1) {                         // grid-uniform
    __shared__ float cluster_amax;
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();                    // every block's red[0] is written
    if (threadIdx.x < 32) {            // lane r reads block r's amax
      float m = threadIdx.x < S
                    ? *cluster.map_shared_rank(red, threadIdx.x) : 0.0f;
      for (int o = kMaxCluster / 2; o > 0; o >>= 1) {
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      }
      if (threadIdx.x == 0) cluster_amax = m;
    }
    cluster_arrive_relaxed();          // done with the others' red
    __syncthreads();
    amax = cluster_amax;
  }
  const float scale = fmaxf(__fdiv_rn(amax, 127.0f), 1e-30f);
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int e = 4 * (threadIdx.x + g * kThreads);
    if (lo + e < hi && e < q_end) {
      const int8_t c0 = code(v[g].x, scale), c1 = code(v[g].y, scale);
      const int8_t c2 = code(v[g].z, scale), c3 = code(v[g].w, scale);
      if (e + 3 < q_end && q4) {
        *reinterpret_cast<uint32_t*>(qs + e) =
            (uint32_t)(uint8_t)c0 | ((uint32_t)(uint8_t)c1 << 8) |
            ((uint32_t)(uint8_t)c2 << 16) | ((uint32_t)(uint8_t)c3 << 24);
      } else {
        qs[e] = c0;
        if (e + 1 < q_end) qs[e + 1] = c1;
        if (e + 2 < q_end) qs[e + 2] = c2;
        if (e + 3 < q_end) qs[e + 3] = c3;
      }
    }
  }
  if (rank == 0 && threadIdx.x == 0) {
    scales[(int64_t)w * n_tiles + tile] = scale;
  }
  if (S > 1) cluster_wait();           // the others are done with ours
}

// int8 code -> f32, exactly: byte b of u, sign bit flipped, as the low
// bits of 2^23's mantissa is 2^23 + b + 128, less 2^23 + 128. Two integer
// operations and a subtraction, where a conversion instruction would wait
// on the card's conversion unit.
__device__ __forceinline__ float code_value(uint32_t u, int byte) {
  const uint32_t bits = 0x4B000000u | (((u >> 8 * byte) & 0xffu) ^ 0x80u);
  return __fsub_rn(__uint_as_float(bits), 8388736.0f);
}

// grid (ceil(P / (V kDequantThreads)), W): thread k of a row takes the
// V codes from column V k on. A tile is a multiple of 1,024 columns where
// P >= 1,024 and the whole row below, so the V never straddle two tiles:
// the thread reads its scale once (a row of one tile, as at P = 6,922,
// without the division). The load of the codes goes out before the
// scale's: at [2, 6922] the kernel's time is the latency of one thread.
__global__ void __launch_bounds__(kDequantThreads)
dequantize_kernel(const int8_t* __restrict__ q,
                  const float* __restrict__ scales, float* __restrict__ y,
                  int P, int row_len, int tile_len, int n_tiles) {
  constexpr int V = kDequantCodes;
  static_assert(V == 4, "one 4-byte load of codes, 16 bytes of products");
  const int w = blockIdx.y;
  const int col = (blockIdx.x * kDequantThreads + threadIdx.x) * V;
  if (col >= P) return;
  const int8_t* qs = q + (int64_t)w * row_len + col;
  float* ys = y + (int64_t)w * P + col;
  // the 4 codes by one 4-byte load, unless the ragged end at P or a row
  // of q that starts off 4 bytes leaves them to the loop below
  const bool whole = col + V <= P && ((uintptr_t)qs & (V - 1)) == 0;
  const uint32_t u = whole ? *reinterpret_cast<const uint32_t*>(qs) : 0u;
  const float s = scales[(int64_t)w * n_tiles +
                         (n_tiles == 1 ? 0 : col / tile_len)];
  if (!whole) {
    // a code at a time (a loop, so the common path's code stays short)
#pragma unroll 1
    for (int e = 0; e < V && col + e < P; ++e) {
      ys[e] = __fmul_rn((float)qs[e], s);
    }
    return;
  }
  float o[V];
#pragma unroll
  for (int e = 0; e < V; ++e) o[e] = __fmul_rn(code_value(u, e), s);
  // the products by a 16-byte store where y's row allows, two 8-byte ones
  // where it starts on 8 bytes (P % 4 == 2), else 4-byte ones (odd P)
  if (((uintptr_t)ys & 15) == 0) {
    *reinterpret_cast<float4*>(ys) = make_float4(o[0], o[1], o[2], o[3]);
  } else if (((uintptr_t)ys & 7) == 0) {
    *reinterpret_cast<float2*>(ys) = make_float2(o[0], o[1]);
    *reinterpret_cast<float2*>(ys + 2) = make_float2(o[2], o[3]);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) ys[e] = o[e];
  }
}

}  // namespace

// quantize's argument list; the version before it took no cluster.
extern "C" int quantize_block_abi() { return 2; }

// Both launch on `stream`, allocate nothing and return the launch's
// cudaError_t as an int (0 == success). The caller checks shapes, dtypes
// and devices; W <= 65535 (grid y), tile_len <= 8192. quantize's
// cluster: the blocks a tile spreads over, 1, 2, 4 or 8
// (cudaErrorInvalidValue otherwise).
extern "C" int quantize_block_f32(const float* x, int8_t* q, float* scales,
                                  int W, int P, int row_len, int tile_len,
                                  int n_tiles, int cluster, void* stream) {
  if (W == 0 || P == 0) return 0;
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)))
    return (int)cudaErrorInvalidValue;
  // each block's span: whole groups of 4, the last block's clipped
  const int span = ((tile_len + cluster - 1) / cluster + 3) & ~3;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(n_tiles * cluster, W);
  config.blockDim = dim3(kThreads);
  config.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, quantize_kernel, x, q, scales, P, row_len, tile_len, n_tiles,
      cluster, span);
  if (err != cudaSuccess) cudaGetLastError();   // not left for the next
  return (int)err;
}

extern "C" int dequantize_block_f32(const int8_t* q, const float* scales,
                                    float* y, int W, int P, int row_len,
                                    int tile_len, int n_tiles,
                                    void* stream) {
  if (W == 0 || P == 0) return 0;
  constexpr int cols = kDequantCodes * kDequantThreads;   // a block's
  const dim3 grid((P + cols - 1) / cols, W);
  dequantize_kernel<<<grid, kDequantThreads, 0, (cudaStream_t)stream>>>(
      q, scales, y, P, row_len, tile_len, n_tiles);
  return (int)cudaGetLastError();
}
