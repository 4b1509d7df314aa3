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
// What held the first design back: one 256-thread block per (tile,
// worker), so the main path's [30, 6922] -- one 7,168-element tile a
// row -- ran 30 blocks on a card of 132 SMs, each thread making 27-28
// trips of two scalar loads and a scalar store: 6.42 us top-k, 6.28 us
// rand-k, 4.2 us above the launch floor.
//
// Design: a tile spreads over a thread-block cluster of S blocks (S = 1,
// 2, 4 or 8: ops.sparsify_cluster, quantize_block's rule doubled while
// the launch stays within one block an SM; 4 at [30, 6922], 8 at [2,
// 6922]), launched with
// cudaLaunchKernelEx. Block r takes the r-th of S equal spans of the tile
// (a multiple of 4 elements), 4 consecutive elements a thread: x and the
// gate by 16-, 8- or 4-byte loads, as the launch's bases, P, the gate's
// stride and the tile allow, predicated rather than branched so that a
// thread's loads stay in flight together; each select is stored as soon
// as it is made. y needs no other block: only the integer count crosses
// them. Block 0's thread 0 zeroes a counter in its shared memory and
// fences it; every thread arrives (relaxed) at a cluster barrier before
// its loads and waits at it after counting, so the barrier's latency
// hides behind the loads. Each block sums its count by warp reductions;
// thread 0 of every other block adds count + 2^16 into block 0's counter
// with one distributed-shared-memory reduction and exits; block 0's
// thread 0 polls the counter until S - 1 arrivals are in it and writes
// nnz (a lost arrival traps after 2^28 polls rather than hanging). Only
// block 0's shared memory is touched from outside, and block 0 is the
// last to exit; nnz needs no zeroing launch. 1,024 threads a block in a
// cluster, 512 where a block takes a whole tile (S = 1). A cluster the
// card refuses is an error the wrapper raises; there is no launch
// without clusters to fall back to.
//
// Measured on an H100 (700 W) against the first design by
// tools/kernel_ab.py, three rounds in one call (PERF.md): [30, 6922]
// top-k / rand-k 1.58-1.59x / 1.58-1.59x (S = 4; S = 1 / 2 / 8 forced
// 1.43x / 1.46x / 1.28-1.29x top-k), [2, 6922] 1.60-1.62x /
// 1.57-1.61x, [30, 100000] 1.28-1.31x / 1.05-1.10x, [30, 1000]
// 1.12-1.13x / 1.08-1.09x. One 1,024-thread block a tile (S = 1) with
// vector accesses, the alternative (kernel_ab.py --set
// kTileThreads=1024): 4.230 / 4.203 us at [30, 6922] against 3.853 /
// 3.840 us over a cluster of 4 in the same call. Tried and lost, each a
// variant timed against the first design in one call: two cluster
// barriers around the count (1.16x at S = 4), a release arrival at the
// first (0.33 us slower than relaxed), 256-thread blocks (1.28x), the
// stores after all the loads (0.85-0.93x at [30, 100000]).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileThreads = 512;      // a block's threads, one a tile
constexpr int kClusterThreads = 1024;  // a block's threads in a cluster
constexpr int kMaxTile = 8 * 1024;
constexpr int kMaxCluster = 8;
constexpr int kArrival = 1 << 16;      // a block's count arrives above it

// predicated loads through the read-only path: where q is false nothing
// is read and the registers keep their values (no branch, so a thread's
// loads stay in flight together)
__device__ __forceinline__ void ld1(float& a, const float* p, bool q) {
  asm("{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n"
      " @q ld.global.nc.f32 %0, [%1];\n}\n"
      : "+f"(a) : "l"(p), "r"((int)q));
}

__device__ __forceinline__ void ld2(float& a, float& b, const float* p,
                                    bool q) {
  asm("{\n .reg .pred q;\n setp.ne.b32 q, %3, 0;\n"
      " @q ld.global.nc.v2.f32 {%0, %1}, [%2];\n}\n"
      : "+f"(a), "+f"(b) : "l"(p), "r"((int)q));
}

__device__ __forceinline__ void ld4(float4& v, const float* p, bool q) {
  asm("{\n .reg .pred q;\n setp.ne.b32 q, %5, 0;\n"
      " @q ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n}\n"
      : "+f"(v.x), "+f"(v.y), "+f"(v.z), "+f"(v.w)
      : "l"(p), "r"((int)q));
}

// the 4 floats from p, of which the first `rem` (any int) exist, zeros
// past them: A floats a load (4: one 16-byte load, 2: two 8-byte ones,
// 1: scalar loads), as the launcher knows every span's address allows;
// the ragged end a float at a time
template <int A>
__device__ __forceinline__ float4 load4(const float* p, int rem) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  const bool full = rem >= 4;
  if constexpr (A == 4) {
    ld4(v, p, full);
  } else if constexpr (A == 2) {
    ld2(v.x, v.y, p, full);
    ld2(v.z, v.w, p + 2, full);
  } else {
    ld1(v.w, p + 3, full);
  }
  if constexpr (A == 1) {
    ld1(v.x, p, rem > 0);
    ld1(v.y, p + 1, rem > 1);
    ld1(v.z, p + 2, rem > 2);
  } else {
    ld1(v.x, p, !full && rem > 0);
    ld1(v.y, p + 1, !full && rem > 1);
    ld1(v.z, p + 2, !full && rem > 2);
  }
  return v;
}

// the first min(rem, 4) of v to p, A floats a store
template <int A>
__device__ __forceinline__ void store4(float* p, float4 v, int rem) {
  if (rem >= 4) {
    if constexpr (A == 4) {
      *reinterpret_cast<float4*>(p) = v;
    } else if constexpr (A == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(v.x, v.y);
      *reinterpret_cast<float2*>(p + 2) = make_float2(v.z, v.w);
    } else {
      p[0] = v.x;
      p[1] = v.y;
      p[2] = v.z;
      p[3] = v.w;
    }
    return;
  }
  if (rem > 0) p[0] = v.x;
  if (rem > 1) p[1] = v.y;
  if (rem > 2) p[2] = v.z;
}

// v where the gate reaches the threshold (counted), else +0; a lane past
// the block's elements (valid false) keeps and counts nothing
__device__ __forceinline__ float keep(float g, float th, float v,
                                      bool valid, int& count) {
  const bool k = valid && g >= th;
  count += k;
  return k ? v : 0.0f;
}

// the block's sum of v (every thread gets it)
template <int kThreads>
__device__ int block_sum(int v, int* red) {
  v = __reduce_add_sync(0xffffffffu, v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < kThreads / 32 ? red[lane] : 0;
  return __reduce_add_sync(0xffffffffu, v);
}

// grid (n_tiles * S, W), clusters of (S, 1, 1); span: the elements of a
// tile a block takes, a multiple of 4
template <int kThreads, int A>
__global__ void __launch_bounds__(kThreads)
sparsify_kernel(const float* __restrict__ x, const float* __restrict__ gate,
                int64_t gate_stride, const float* __restrict__ thresh,
                float* __restrict__ y, int32_t* __restrict__ nnz, int P,
                int tile_len, int n_tiles, int S, int span) {
  constexpr int kGroups = kMaxTile / (4 * kThreads);   // of 4, S = 1
  __shared__ int red[kThreads / 32];
  __shared__ int cluster_count;        // block 0's: counts and arrivals
  const int w = blockIdx.y;
  const int rank = blockIdx.x % S;     // the block's rank in its cluster
  const int tile = blockIdx.x / S;
  const int lo = rank * span, hi = min(lo + span, tile_len);
  const int64_t start = (int64_t)tile * tile_len + lo;
  if (S > 1) {                         // grid-uniform
    if (rank == 0 && threadIdx.x == 0) {
      cluster_count = 0;
      asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
    }
    // waited for once counted
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  }
  const float th = thresh[w];
  const float* xs = x + (int64_t)w * P + start;
  const float* gs = gate + (int64_t)w * gate_stride + start;
  float* ys = y + (int64_t)w * P + start;
  // the block's elements before P and its tile's end
  const int64_t len = min((int64_t)(hi - lo), (int64_t)P - start);
  int count = 0;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int e = 4 * (threadIdx.x + g * kThreads);   // from lo
    const int rem = (int)(len - e);    // of its 4, those in the span
    const float4 a = load4<A>(xs + e, rem), b = load4<A>(gs + e, rem);
    float4 v;
    v.x = keep(b.x, th, a.x, rem > 0, count);
    v.y = keep(b.y, th, a.y, rem > 1, count);
    v.z = keep(b.z, th, a.z, rem > 2, count);
    v.w = keep(b.w, th, a.w, rem > 3, count);
    store4<A>(ys + e, v, rem);         // y needs no other block
  }
  count = block_sum<kThreads>(count, red);
  if (S > 1) {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    if (rank > 0) {                    // the count into block 0's counter
      if (threadIdx.x == 0) {
        const unsigned local =
            (unsigned)__cvta_generic_to_shared(&cluster_count);
        unsigned remote;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                     : "=r"(remote) : "r"(local), "r"(0));
        asm volatile("red.relaxed.cluster.shared::cluster.add.u32 [%0], %1;\n"
                     ::"r"(remote), "r"(count + kArrival) : "memory");
      }
      return;
    }
    if (threadIdx.x == 0) {            // block 0 waits for S - 1 arrivals
      volatile int* c = &cluster_count;
      int seen = *c;
      for (long long spins = 0; seen < (S - 1) * kArrival; ++spins) {
        if (spins > (1ll << 28)) __trap();   // a lost arrival: an error
        seen = *c;
      }
      count += seen & (kArrival - 1);
    }
  }
  if (rank == 0 && threadIdx.x == 0) {
    nnz[(int64_t)w * n_tiles + tile] = count;
  }
}

template <int T>
cudaError_t launch(int a, const cudaLaunchConfig_t* config, const float* x,
                   const float* gate, int64_t gate_stride,
                   const float* thresh, float* y, int32_t* nnz, int P,
                   int tile_len, int n_tiles, int S, int span) {
  if (a == 4) {
    return cudaLaunchKernelEx(config, sparsify_kernel<T, 4>, x, gate,
                              gate_stride, thresh, y, nnz, P, tile_len,
                              n_tiles, S, span);
  }
  if (a == 2) {
    return cudaLaunchKernelEx(config, sparsify_kernel<T, 2>, x, gate,
                              gate_stride, thresh, y, nnz, P, tile_len,
                              n_tiles, S, span);
  }
  return cudaLaunchKernelEx(config, sparsify_kernel<T, 1>, x, gate,
                            gate_stride, thresh, y, nnz, P, tile_len,
                            n_tiles, S, span);
}

}  // namespace

// The launcher's argument list; the version before it took no cluster.
extern "C" int sparsify_block_abi() { return 2; }

// Launches on `stream`, allocates nothing and returns the launch's
// cudaError_t as an int (0 == success). gate_stride is P (a gate row per
// worker) or 0 (one shared row); cluster: the blocks a tile spreads
// over, 1, 2, 4 or 8 (cudaErrorInvalidValue otherwise). The caller
// checks shapes, dtypes and devices; W <= 65535 (grid y), tile_len <=
// 8192.
extern "C" int sparsify_block_f32(const float* x, const float* gate,
                                  int64_t gate_stride, const float* thresh,
                                  float* y, int32_t* nnz, int W, int P,
                                  int tile_len, int n_tiles, int cluster,
                                  void* stream) {
  if (W == 0 || P == 0) return 0;
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) ||
      tile_len > kMaxTile)
    return (int)cudaErrorInvalidValue;
  // each block's span: whole groups of 4, the last block's clipped
  const int span = ((tile_len + cluster - 1) / cluster + 3) & ~3;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(n_tiles * cluster, W);
  config.blockDim = dim3(cluster > 1 ? kClusterThreads : kTileThreads);
  config.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  // the widest access every block's span allows: x, the gate and y
  // rows, tiles and spans all start on 4 A bytes
  const uintptr_t bases = (uintptr_t)x | (uintptr_t)gate | (uintptr_t)y;
  const int64_t steps = P | gate_stride | tile_len;
  const int a = (bases & 15) == 0 && steps % 4 == 0  ? 4
                : (bases & 7) == 0 && steps % 2 == 0 ? 2
                                                     : 1;
  const cudaError_t err =
      cluster > 1 ? launch<kClusterThreads>(a, &config, x, gate, gate_stride,
                                            thresh, y, nnz, P, tile_len,
                                            n_tiles, cluster, span)
                  : launch<kTileThreads>(a, &config, x, gate, gate_stride,
                                         thresh, y, nnz, P, tile_len,
                                         n_tiles, cluster, span);
  if (err != cudaSuccess) cudaGetLastError();   // not left for the next
  return (int)err;
}
