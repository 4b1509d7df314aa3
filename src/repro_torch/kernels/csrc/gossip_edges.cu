// gossip_edges: sparse Eq. 5 gossip over a directed edge list, f32.
//
//     y[d, :] = x[d, :] + sum_{e into d} w[e] * (t[src_e, :] - x[d, :])
//
// x, t, y [W, P] contiguous row-major f32; the edges in CSR form sorted by
// destination: row_ptr [W + 1], col [E] (the sources), w [E], int32 /
// int32 / f32. Honest gossip passes t = x; the attacked baseline passes
// the transmitted (corrupted) copy as t. Every delta reads the pre-mix x.
//
// Replaces the TPU kernel repro/kernels/gossip_edges.py:gossip_edges
// (body _edges_kernel): one program per column tile walking the whole
// edge list in list order with a fori_loop, all W rows resident. On a
// GPU, a scatter with atomics would add each row's deltas in an order
// that changes from run to run; here the host sorts the edges by
// destination with a stable sort (core/topology.edges_to_csr), so each
// row adds its edges in list order -- the reference's order -- and the
// kernel gathers instead of scattering. Zero-weight padding edges of the
// TPU version are not needed: entries past row_ptr[W] are never read.
//
// Arithmetic: acc = x[d], then acc = acc + w * (t - x_d) per edge in CSR
// order, each step rounded separately (__fsub_rn / __fmul_rn / __fadd_rn
// keep nvcc from contracting it into an FMA), so the result is bit-equal
// to the plain version (repro_torch/kernels/ref.py:gossip_edges_ref).
// Both instances below keep that order for every element: they
// parallelise over rows and columns, never over a row's edges.
//
// Bound: the function reads x (and t when t is not x) once, the CSR
// arrays once and writes y once: (2 W P [+ W P] + W + 1 + 2 E) * 4
// bytes -- 1.66 MB at W = 30, P = 6922, E = 870 (0.50 us at 3.35 TB/s);
// 113.4 MB at the W = 2,048 ring (33.9 us). Its 3 E P operations (19
// MFLOP at E = 870) are 0.27 us at 67 TFLOP/s, so bytes bound it.
//
// What held the first design back (one thread per (row d, column c), 256
// columns a block, each thread walking row d's edges with scalar loads of
// col[e] and then of t[col[e], c]): at W = 30 every destination row read
// each of its 29 source rows itself, E P 4 = 24.1 MB of L2 traffic for a
// function whose bound reads 1.66 MB, as a serial chain of 29 dependent
// L2 round trips a thread -- 8.0 us, 5.8 us above the launch floor; on
// the W = 2,048 ring, whose 113 MB are past the 50 MB L2, scalar loads
// behind a dependent index load kept too few bytes in flight: 96.5 us,
// about 1.2 TB/s.
//
// Two instances; ops.edges_instance picks one from W (the wrapper passes
// it to the launcher):
//
// staged (W <= ops.EDGES_STAGED_MAX_ROWS = 32: every W = 30 path). One
// block of G warps per (tile of kStagedCols = 128 columns, group of G <=
// kStagedMaxRows destination rows: 2 groups of 15 at W = 30, 55 tiles at
// P = 6,922). Each warp first loads its row's CSR range (and the block
// its group's), then the block copies t[0:W, tile] into shared memory
// with cp.async, all in flight at once, 16, 8 or 4 bytes a copy as the
// launch's x, t and y bases and P allow (8 at P = 6,922). The group's
// rows of x (unless t is x, the same pointer: then x[d] comes from the
// tile) follow once the group is known to need the tile: issued with it,
// they left the lying twins 1-3% slower. Each warp stages its CSR
// entries, as source offsets into the tile and weights, kWarpEdges at a
// time (any degree runs), and after the block's one barrier walks them
// four at a time: one 16-byte read of four offsets, one of four weights,
// four independent 16-byte reads of the sources, the adds in order. A lane
// owns 4 adjacent columns; every source value comes from shared memory,
// so L2 traffic for t falls from E P 4 bytes to W P 4 a row group. A
// group of at most kDirectDegree = 2 edges a row (a ring) needs a few
// rows, not the tile: its warps gather their sources from device memory
// as the gather instance does, without the barrier (W = 32 ring: 1.01x
// the first design, against 0.94x through the tile; the copies already
// issued are waited for before the block exits).
//
// gather (W > 32). One block of kGatherThreads = 128 threads per (column
// tile, destination row), rows on the grid's y axis: blocks issue in row
// order, so a ring neighbour's row is still in L2. A thread owns V
// adjacent columns, V = 4 from kGatherWideRows = 512 rows on (the W =
// 2,048 ring and ba:2 graphs), 2 below (twice the blocks, and a hub
// row's gathers spread over twice the warps). Lanes load 32 CSR entries
// at once and hand them round by shuffles; each thread then issues
// kGatherUnroll = 4 edges' gathers at once and adds them in order. Rows
// are read 16, 8 or 4 bytes at a time as the launch's x, t and y bases
// and P allow (odd P and offset views work). The loads are predicated,
// not branched, and only the warp that reaches P takes the element-wise
// path: with a branch per load for the ragged end, nvcc waited for each
// load where its branches joined, so a hub row's gathers ran one after
// another (W = 300 star, in-degree 299, 4 columns a thread: 35.3 us
// against 31.7 us; 23.4 us with 2 columns a thread).
//
// Measured on an H100 (700 W) against the first design by
// tools/kernel_ab.py, three rounds in one call (PERF.md). Staged: full30
// 1.62x, odd P 1.60-1.66x, offset views 1.61-1.62x, ring30-pad
// 1.00-1.01x (over a lying wire 0.97-0.99x), ba:2 at W = 32 1.00-1.03x
// (lying 0.97-1.00x). Gather: ring2048 1.79x, ba2048 1.59-1.60x, W =
// 300 star 1.12x, ba:2 W = 33 1.00-1.01x. The limit, from kernel_ab's
// EDGES_SWEEP with each instance forced (same call): at W = 32 the
// staged instance wins on ba:2 (1.04-1.06x against 0.97-0.99x) and
// complete graphs (1.65-1.66x against 1.25-1.26x), and ties on a ring
// (1.01-1.02x against 1.01-1.04x); from W = 48 the gather one wins on
// sparse graphs (ba:2 1.05-1.06x against 1.00-1.02x, ring 1.12x against
// 0.98-1.00x), which stage all W rows to use a few; on complete graphs
// the staged one wins up to its shared memory (W = 128: 2.30x against
// 1.27-1.28x), but no path runs one past W = 30. Each variant below was
// built with a constexpr changed (kernel_ab.py --set) or from its own
// source, and timed against the first design in one call.
// Tried and lost: the staged tile through registers (full30 1.49x
// against 1.63x), 2 columns a lane (1.44x against 1.57x), the CSR range
// loaded after the tile's copies (0.17 us slower: the row_ptr load
// queued behind them), a copy width chosen per row (ring30-pad
// 0.93-0.95x against 0.97-0.98x); gathers through L2 only (__ldcg) or
// cached at every level (__ldca) (star300 0.57x, ring2048 1.72-1.76x
// against 0.74x and 1.81x), 8 gathers in flight (ring2048 1.49x: the
// registers cut occupancy), one column a thread (ring2048 0.93x), 4
// columns below W = 512 (star300 0.82x, ba:2 W = 65 0.92x), each thread
// staging its own columns of 8 or 16 sources by cp.async (star300
// 0.49-0.52x).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr size_t kMaxSmem = 232448;    // a block's shared memory, bytes
// staged: a tile's width (4 columns a lane), warps (rows) a block at
// most, CSR entries a warp stages a pass
constexpr int kStagedCols = 128;
constexpr int kStagedMaxRows = 16;
constexpr int kWarpEdges = 128;
// gather: threads a block, gathers in flight a thread, and the fleets
// from which a thread takes 4 columns, not 2
constexpr int kGatherThreads = 128;
constexpr int kGatherUnroll = 4;
constexpr int kGatherWideRows = 512;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kDirectDegree = 2;

__device__ __forceinline__ float mix_step(float acc, float w, float s,
                                          float xd) {
  return __fadd_rn(acc, __fmul_rn(w, __fsub_rn(s, xd)));
}

__device__ __forceinline__ float4 mix4(float4 acc, float w, float4 s,
                                       float4 xd) {
  return make_float4(mix_step(acc.x, w, s.x, xd.x),
                     mix_step(acc.y, w, s.y, xd.y),
                     mix_step(acc.z, w, s.z, xd.z),
                     mix_step(acc.w, w, s.w, xd.w));
}

// asynchronous copies global -> shared of 4, 8 and 16 bytes; src_bytes 0
// zero-fills the 4
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async8(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

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

// 4 adjacent floats of shared memory (16-byte aligned)
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// a warp's CSR entries [lo, lo + m) into its slice of shared memory: the
// source rows' offsets into the tile and the weights, apart
__device__ __forceinline__ void stage_warp_edges(int* so, float* sw,
                                                 const int* col,
                                                 const float* w, int lo,
                                                 int m, int lane) {
  for (int j = lane; j < m; j += 32) {
    so[j] = col[lo + j] * kStagedCols;
    sw[j] = w[lo + j];
  }
}

// V floats from p into v, zeros where nothing is read: with kFull (every
// lane of the warp has its V columns before P) by loads of min(A, V)
// floats where `live`; else a float at a time, those before P
template <int A, int V, bool kFull>
__device__ __forceinline__ void loadv(float (&v)[V], const float* p,
                                      int rem, bool live) {
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = 0.f;
  constexpr int L = A < V ? A : V;
#pragma unroll
  for (int i = 0; i < V; i += L) {
    if constexpr (!kFull) {
#pragma unroll
      for (int k = 0; k < L; ++k) {
        ld1(v[i + k], p + i + k, live && i + k < rem);
      }
    } else if constexpr (L == 4) {
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
      ld4(q, p + i, live);
      v[i] = q.x;
      v[i + 1] = q.y;
      v[i + 2] = q.z;
      v[i + 3] = q.w;
    } else if constexpr (L == 2) {
      ld2(v[i], v[i + 1], p + i, live);
    } else {
      ld1(v[i], p + i, live);
    }
  }
}

template <int A, int V, bool kFull>
__device__ __forceinline__ void storev(float* p, const float (&v)[V],
                                       int rem) {
  constexpr int L = A < V ? A : V;
#pragma unroll
  for (int i = 0; i < V; i += L) {
    if constexpr (!kFull) {
#pragma unroll
      for (int k = 0; k < L; ++k) {
        if (i + k < rem) p[i + k] = v[i + k];
      }
    } else if constexpr (L == 4) {
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    } else if constexpr (L == 2) {
      *reinterpret_cast<float2*>(p + i) = make_float2(v[i], v[i + 1]);
    } else {
      p[i] = v[i];
    }
  }
}

// row d's columns [c, c + V) of one thread
template <int A, int V, bool kFull>
__device__ __forceinline__ void gather_row(
    const float* __restrict__ x, const float* __restrict__ t,
    const int* __restrict__ col, const float* __restrict__ w,
    float* __restrict__ y, int P, int d, int c, int lo, int hi, int lane) {
  constexpr int U = kGatherUnroll;
  const int rem = P - c;                // of its V, those before P
  const int64_t at = (int64_t)d * P + c;
  float xd[V], acc[V];
  loadv<A, V, kFull>(xd, x + at, rem, true);
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = xd[v];
  for (int base = lo; base < hi; base += 32) {
    // 32 CSR entries a pass, one a lane, handed round by shuffles
    const int n = min(32, hi - base);
    const int mc = lane < n ? col[base + lane] : 0;
    const float mw = lane < n ? w[base + lane] : 0.f;
    for (int j = 0; j < n; j += U) {
      int src[U];
      float wt[U], s[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        src[u] = __shfl_sync(kFullMask, mc, (j + u) & 31);
        wt[u] = __shfl_sync(kFullMask, mw, (j + u) & 31);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {    // U gathers in flight
        loadv<A, V, kFull>(s[u], t + (int64_t)src[u] * P + c, rem,
                           j + u < n);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {    // the adds in CSR order
        if (j + u < n) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            acc[v] = mix_step(acc[v], wt[u], s[u][v], xd[v]);
          }
        }
      }
    }
  }
  storev<A, V, kFull>(y + at, acc, rem);
}

// the first min(rem, 4) floats from p to shared dst (16-byte aligned) by
// copies of A floats (every row's address allows it), the ragged end a
// float at a time with zeros past P; nothing where rem <= 0
template <int A>
__device__ __forceinline__ void copyA(float* dst, const float* p, int rem) {
  if (rem >= 4) {
    if constexpr (A == 4) {
      cp_async16(dst, p);
    } else if constexpr (A == 2) {
      cp_async8(dst, p);
      cp_async8(dst + 2, p + 2);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) cp_async4(dst + i, p + i, 4);
    }
  } else if (rem > 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      cp_async4(dst + i, p + (i < rem ? i : 0), i < rem ? 4 : 0);
    }
  }
}

// grid (tiles, row groups), G warps; dynamic shared memory [W][kStagedCols]
// t tile, [G][kStagedCols] x rows (unless alias), [G][kWarpEdges] source
// offsets and [G][kWarpEdges] weights; A floats a copy at most
template <int A>
__global__ void __launch_bounds__(32 * kStagedMaxRows)
edges_staged_kernel(const float* __restrict__ x, const float* __restrict__ t,
                    const int* __restrict__ row_ptr,
                    const int* __restrict__ col, const float* __restrict__ w,
                    float* __restrict__ y, int W, int P, int G, int alias) {
  extern __shared__ __align__(16) float smem[];
  constexpr int TC = kStagedCols;
  const int g0 = blockIdx.y * G;
  float* st = smem;
  float* sx = st + (size_t)W * TC;
  int* so = reinterpret_cast<int*>(sx + (alias ? 0 : G * TC));
  float* sw = reinterpret_cast<float*>(so + G * kWarpEdges);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile0 = blockIdx.x * TC;
  const int rem = P - tile0;            // the tile's columns before P
  // warp j's row d: its CSR range first, so that the loads go out ahead
  // of the tile's copies
  const int d = g0 + warp;
  int lo = 0, hi = 0;
  if (d < W) {
    lo = row_ptr[d];
    hi = row_ptr[d + 1];
  }
  // the group's CSR range (the same for every thread of the block)
  const int gl = row_ptr[g0], gh = row_ptr[min(g0 + G, W)];

  // the t tile, warp j copying rows j, j + G, ..., lane i its columns
  // 4 i .. 4 i + 3
  const int c = tile0 + lane * 4;
  for (int r = warp; r < W; r += G) {
    copyA<A>(st + r * TC + lane * 4, t + (int64_t)r * P + c, rem - lane * 4);
  }
  if (gh - gl <= kDirectDegree * G) {
    // a sparse group: each warp gathers its row's sources from device
    // memory, and the block needs neither the tile nor its barrier (the
    // copies went out before the group's range arrived, so as not to
    // hold back a dense group's)
    if (d < W) {
      if (rem >= TC) {
        gather_row<A, 4, true>(x, t, col, w, y, P, d, c, lo, hi, lane);
      } else {
        gather_row<A, 4, false>(x, t, col, w, y, P, d, c, lo, hi, lane);
      }
    }
    cp_async_wait_all();               // no copy outlives its block
    return;
  }
  // the group's rows of x, which only this path reads, and each warp's
  // first CSR entries, beside the copies
  if (!alias && d < W) {
    copyA<A>(sx + warp * TC + lane * 4, x + (int64_t)d * P + c,
             rem - lane * 4);
  }
  int* mo = so + warp * kWarpEdges;
  float* mw = sw + warp * kWarpEdges;
  int m = min(hi - lo, kWarpEdges);
  stage_warp_edges(mo, mw, col, w, lo, m, lane);
  cp_async_wait_all();
  __syncthreads();                      // the block's only barrier
  if (d >= W) return;

  const float* sl = st + lane * 4;       // the lane's 4 columns
  const float4 xd =
      lds4((alias ? st + (size_t)d * TC : sx + warp * TC) + lane * 4);
  float4 acc = xd;
  for (int base = lo;;) {
    int e = 0;
    for (; e + 4 <= m; e += 4) {        // 4 sources' loads in flight
      const int4 o = *reinterpret_cast<const int4*>(mo + e);
      const float4 q = *reinterpret_cast<const float4*>(mw + e);
      const float4 s0 = lds4(sl + o.x), s1 = lds4(sl + o.y),
                   s2 = lds4(sl + o.z), s3 = lds4(sl + o.w);
      acc = mix4(mix4(mix4(mix4(acc, q.x, s0, xd), q.y, s1, xd), q.z, s2,
                      xd),
                 q.w, s3, xd);
    }
    for (; e < m; ++e) acc = mix4(acc, mw[e], lds4(sl + mo[e]), xd);
    base += m;
    if (base >= hi) break;
    m = min(hi - base, kWarpEdges);     // a row past kWarpEdges entries
    __syncwarp();
    stage_warp_edges(mo, mw, col, w, base, m, lane);
    __syncwarp();
  }
  float* yr = y + (int64_t)d * P + c;
  const int left = rem - lane * 4;      // of its 4, those before P
  if (left > 0) yr[0] = acc.x;
  if (left > 1) yr[1] = acc.y;
  if (left > 2) yr[2] = acc.z;
  if (left > 3) yr[3] = acc.w;
}

// grid (tiles, W), kGatherThreads threads: block (i, d) takes V columns a
// thread of row d from column i kGatherThreads V; A floats a load and
// store at most (every row's address allows it)
template <int A, int V>
__global__ void __launch_bounds__(kGatherThreads)
edges_gather_kernel(const float* __restrict__ x, const float* __restrict__ t,
                    const int* __restrict__ row_ptr,
                    const int* __restrict__ col, const float* __restrict__ w,
                    float* __restrict__ y, int P) {
  const int d = blockIdx.y, lane = threadIdx.x & 31;
  const int first = blockIdx.x * kGatherThreads + threadIdx.x;
  const int lo = row_ptr[d], hi = row_ptr[d + 1];
  // warp-uniform: whether every lane's V columns lie before P
  if ((first | 31) * V + V <= P) {
    gather_row<A, V, true>(x, t, col, w, y, P, d, first * V, lo, hi, lane);
  } else {
    gather_row<A, V, false>(x, t, col, w, y, P, d, first * V, lo, hi, lane);
  }
}

// the staged instance's shared memory at W rows, G of them a block
constexpr size_t staged_smem(int W, int G, int alias) {
  return (size_t)(W + (alias ? 0 : G)) * kStagedCols * sizeof(float) +
         (size_t)G * kWarpEdges * (sizeof(int) + sizeof(float));
}

// the most rows the staged instance takes: its t tile, the x rows and the
// CSR entries of a group of kStagedMaxRows rows in a block's 227 KB of
// shared memory (406 rows)
constexpr int kStagedCapacity =
    (int)((kMaxSmem - (size_t)kStagedMaxRows * kWarpEdges *
                          (sizeof(int) + sizeof(float))) /
          (kStagedCols * sizeof(float))) -
    kStagedMaxRows;
static_assert(staged_smem(kStagedCapacity, kStagedMaxRows, 0) <= kMaxSmem &&
                  staged_smem(kStagedCapacity + 1, kStagedMaxRows, 0) >
                      kMaxSmem,
              "kStagedCapacity is the most rows a block's shared memory "
              "holds");

// the widest access (floats) every row of x, t and y allows
int row_access(const float* x, const float* t, const float* y, int P) {
  const uintptr_t bases = (uintptr_t)x | (uintptr_t)t | (uintptr_t)y;
  if ((bases & 15) == 0 && P % 4 == 0) return 4;
  if ((bases & 7) == 0 && P % 2 == 0) return 2;
  return 1;
}

template <int A>
cudaError_t launch_staged_a(const float* x, const float* t,
                            const int* row_ptr, const int* col,
                            const float* w, float* y, int W, int P,
                            cudaStream_t stream) {
  const int alias = x == t;
  const int tiles = (P + kStagedCols - 1) / kStagedCols;
  // the fewest row groups of at most kStagedMaxRows rows, as even as
  // they can be: 2 groups of 15 at W = 30
  const int groups = (W + kStagedMaxRows - 1) / kStagedMaxRows;
  const int G = (W + groups - 1) / groups;
  const size_t smem = staged_smem(W, G, alias);
  static size_t opted_in = 48 * 1024;  // once per size and process
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        edges_staged_kernel<A>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  edges_staged_kernel<A><<<dim3(tiles, (W + G - 1) / G), 32 * G, smem,
                           stream>>>(x, t, row_ptr, col, w, y, W, P, G,
                                     alias);
  return cudaGetLastError();
}

cudaError_t launch_staged(const float* x, const float* t, const int* row_ptr,
                          const int* col, const float* w, float* y, int W,
                          int P, cudaStream_t stream) {
  switch (row_access(x, t, y, P)) {
    case 4:
      return launch_staged_a<4>(x, t, row_ptr, col, w, y, W, P, stream);
    case 2:
      return launch_staged_a<2>(x, t, row_ptr, col, w, y, W, P, stream);
    default:
      return launch_staged_a<1>(x, t, row_ptr, col, w, y, W, P, stream);
  }
}

template <int V>
cudaError_t launch_gather_v(const float* x, const float* t,
                            const int* row_ptr, const int* col,
                            const float* w, float* y, int W, int P,
                            cudaStream_t stream) {
  const dim3 grid((P + kGatherThreads * V - 1) / (kGatherThreads * V), W);
  switch (row_access(x, t, y, P)) {
    case 4:
      edges_gather_kernel<4, V><<<grid, kGatherThreads, 0, stream>>>(
          x, t, row_ptr, col, w, y, P);
      break;
    case 2:
      edges_gather_kernel<2, V><<<grid, kGatherThreads, 0, stream>>>(
          x, t, row_ptr, col, w, y, P);
      break;
    default:
      edges_gather_kernel<1, V><<<grid, kGatherThreads, 0, stream>>>(
          x, t, row_ptr, col, w, y, P);
  }
  return cudaGetLastError();
}

cudaError_t launch_gather(const float* x, const float* t, const int* row_ptr,
                          const int* col, const float* w, float* y, int W,
                          int P, cudaStream_t stream) {
  return W >= kGatherWideRows
             ? launch_gather_v<4>(x, t, row_ptr, col, w, y, W, P, stream)
             : launch_gather_v<2>(x, t, row_ptr, col, w, y, W, P, stream);
}

}  // namespace

// The launcher's argument list; the version before it took no instance.
extern "C" int gossip_edges_abi() { return 2; }

// Launches on `stream`, allocates nothing, and returns a cudaError_t as
// an int (0 == success). staged 1 runs the staged instance
// (cudaErrorInvalidValue past kStagedCapacity rows), 0
// the gather instance. The caller checks shapes, dtypes and devices;
// W <= 65535 (rows on grid y), P < 2**31.
extern "C" int gossip_edges_f32(const float* x, const float* t,
                                const int* row_ptr, const int* col,
                                const float* w, float* y, int W, int P,
                                int staged, void* stream) {
  if (W == 0 || P == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (staged) {
    if (W > kStagedCapacity) return (int)cudaErrorInvalidValue;
    return (int)launch_staged(x, t, row_ptr, col, w, y, W, P, st);
  }
  return (int)launch_gather(x, t, row_ptr, col, w, y, W, P, st);
}
