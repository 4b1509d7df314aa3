// sparsify_block: the top-k / rand-k wire codecs' mask-and-pack on a
// fleet's flat [W, P] f32 rows.
//
//     y[w, i]     = gate[w, i] >= thresh[w] ? x[w, i] : 0.0f
//     nnz[w, t]   = number of kept coordinates of tile t of row w
//
// gate is [W, P] (top-k: |x|) or one [P] row shared by every worker
// (rand-k's seeded mask, read with row stride 0). thresh [W] is each
// row's k-th largest gate value, computed outside the kernel (torch.topk,
// as the reference computes it with lax.top_k outside its kernel). The
// tiles are the int8 codec's (quantize_block.cu): tile t of a row is the
// span [t * tile_len, (t + 1) * tile_len), clipped at P; coordinates past
// P never count (the reference pads its gate with -1 for that).
//
// Replaces the TPU kernel repro/kernels/sparsify_block.py:
// sparsify_block_2d (body _sparsify_kernel), which the reference's fused
// engine vmaps over the W workers' [rows, cols] matrices
// (repro/core/compression.py:sparsify_rows).
//
// A pure select: y is bit-equal to the plain version
// (repro_torch/kernels/ref.py) and to the reference's oracle; the count
// is an integer sum, exact in any order.
//
// Bound: x and gate read once, y and nnz written once: (12 W P + 8 W)
// bytes with a per-row gate, (8 W P + 4 P + 8 W) with the shared rand-k
// row -- 2.49 MB and 1.69 MB at W = 30, P = 6922, 0.74 us and 0.50 us at
// the H100's 3.35 TB/s. Bytes bound it, and at this size the launch
// latency dominates.
//
// Design: one block per (tile, worker); 256 threads stride the tile
// (neighbouring threads on neighbouring elements, scalar loads since rows
// are not 16-byte aligned), each counts its survivors, and the block sums
// the counts with warp shuffles and shared memory; thread 0 stores it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sparsify_kernel(const float* __restrict__ x, const float* __restrict__ gate,
                int64_t gate_stride, const float* __restrict__ thresh,
                float* __restrict__ y, int32_t* __restrict__ nnz, int P,
                int tile_len, int n_tiles) {
  __shared__ int red[kThreads / 32];
  const int w = blockIdx.y;
  const int64_t start = (int64_t)blockIdx.x * tile_len;
  const int64_t end = start + tile_len;
  const int64_t stop = end < P ? end : P;
  const float th = thresh[w];
  const float* xr = x + (int64_t)w * P;
  const float* gr = gate + (int64_t)w * gate_stride;
  float* yr = y + (int64_t)w * P;
  int count = 0;
  for (int64_t idx = start + threadIdx.x; idx < stop; idx += kThreads) {
    const bool keep = gr[idx] >= th;
    yr[idx] = keep ? xr[idx] : 0.0f;
    count += keep;
  }
  for (int o = 16; o > 0; o >>= 1) {
    count += __shfl_xor_sync(0xffffffffu, count, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int i = 0; i < kThreads / 32; ++i) total += red[i];
    nnz[(int64_t)w * n_tiles + blockIdx.x] = total;
  }
}

}  // namespace

// Launches on `stream`, allocates nothing and returns cudaGetLastError()
// as an int (0 == success). gate_stride is P (a gate row per worker) or 0
// (one shared row). The caller checks shapes, dtypes and devices;
// W <= 65535 (grid y).
extern "C" int sparsify_block_f32(const float* x, const float* gate,
                                  int64_t gate_stride, const float* thresh,
                                  float* y, int32_t* nnz, int W, int P,
                                  int tile_len, int n_tiles, void* stream) {
  if (W == 0 || P == 0) return 0;
  const dim3 grid(n_tiles, W);
  sparsify_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, gate, gate_stride, thresh, y, nnz, P, tile_len, n_tiles);
  return (int)cudaGetLastError();
}
