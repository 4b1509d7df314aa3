// robust_gossip: Byzantine-robust gossip (trimmed mean or median of each
// worker's closed neighbourhood, coordinate-wise), f32.
//
// For worker i with deg[i] = d neighbours nbr[i, 0..d-1]: the window
// {x[i, c]} U {t[nbr[i, k], c] : k < d} -- its own honest row and the
// transmitted rows of its neighbours -- is sorted ascending, then
//   trimmed: y = (sum of positions [b_i, cnt - b_i)) / (cnt - 2 b_i),
//            cnt = d + 1, b_i = floor(b * cnt) in f32 for a fractional b
//            (int(b) otherwise), clamped to (cnt - 1) / 2;
//   median:  y = 0.5 * (v[(cnt - 1) / 2] + v[cnt / 2]);
// a worker with d = 0 keeps x[i, c].
//
// x, t, y [W, P] contiguous row-major f32; nbr [W, D] int32 (row i lists
// its neighbours, then padding), deg [W] int32.
//
// Replaces the TPU kernel repro/kernels/robust_gossip.py:robust_gossip
// (bodies _robust_kernel, _sort_rows): one program per column tile
// walking the workers with a fori_loop, gathering a [D + 1, 256] window,
// masking the padding slots to +inf and sorting it with an odd-even
// transposition network of D + 1 passes. Here one thread owns one
// (worker, column) window in registers: D_PAD + 1 floats, D_PAD a
// template parameter (a power of two, 1..64; the fused engine pads each
// segment's neighbour table to one such D), and sorts it with the same
// network, fully unrolled -- compare-exchanges on registers with fminf /
// fmaxf, no data-dependent branches, so the warp stays in step. Any
// correct sort puts the same values in the same positions; the sum then
// adds the window in ascending position order (__fadd_rn) and divides
// with __fdiv_rn, the plain version's order (repro_torch/kernels/ref.py:
// robust_gossip_ref), so the two agree bit for bit.
//
// Bound: the function reads x, t and the table once and writes y once:
// (3 W P + W D + W) * 4 bytes -- 2.49 MB at W = 30, P = 6922 (0.74 us at
// 3.35 TB/s), 170.1 MB at the W = 2,048 ring (50.8 us). Its operations
// are the network's compare-exchanges, D_PAD + 1 passes of D_PAD / 2 each
// per window (528 at D_PAD = 32: 1,056 min/max), 219 MFLOP at W = 30,
// P = 6922: 3.3 us at 67 TFLOP/s. So at D_PAD = 32 operations bind it;
// at the ring's D_PAD = 2 (3 compare-exchanges) bytes do.
//
// Each neighbour row of t is read once per worker that lists it (from L2
// at these sizes). A later version could sort only as far as the window
// needs (a partial network), or stage t's column tile in shared memory.
//
// The wide instance, for tables of D > 64 (a fleet of more than 65
// workers on a dense base, or a hub of degree 65 or more): a register
// window stops there -- 129 floats a thread for D_PAD = 128 would spill,
// and an unrolled network of that size is some 8,000 instructions -- so
// the window moves to shared memory. It replaces the same Pallas kernel,
// which has no limit on D (d_pad = max(D, 1)). One block of 256 threads
// owns (worker i, a tile of C consecutive columns). It stages worker i's
// window {x[i, c]} U {t[nbr[i, k], c] : k < deg[i]} in dynamic shared
// memory as N rows of C floats (N = the next power of two >= deg[i] + 1,
// the rows past the window +inf). A thread keeps one column c = tid mod
// C and walks the rows tid / C, tid / C + 256 / C, ... of it, with
// shifts (C is a power of two; an index divided by a C known only at run
// time cost some 20 instructions a compare-exchange and made the first
// version 2-4x slower), so a warp reads 32 consecutive columns of one
// neighbour's row, coalesced, and writes 32 consecutive floats (32
// banks) of shared memory. It sorts every column with a bitonic network,
// log2 N (log2 N + 1) / 2 stages of N / 2 compare-exchanges a column
// (fminf / fmaxf), a __syncthreads between stages; a stage's pair (lo,
// lo + j) of column c sits at lo * C + c, so the threads of a warp touch
// consecutive columns, free of bank conflicts for C >= 32. Then the
// thread of row 0 of column c adds the column's positions
// [b_i, cnt - b_i) in ascending order with __fadd_rn and divides with
// __fdiv_rn (the median: 0.5 (v[lo] + v[hi])): the plain version's
// order, so this instance is bit-equal to it too. C is the largest power
// of two <= 128 with N * C * 4 <= 96 KB (two blocks an SM), and 1 past
// that (N of 32,768 takes 128 KB); the launcher opts the instance in to
// the largest once. The limit: one column's window must fit a block's
// shared memory (227 KB), so N <= 32,768 and D <= 32,767
// (ROBUST_SHARED_MAX_DEGREE in ops.py); 65,536 floats are 256 KB.
//
// Wide bound: the same bytes, (3 W P + W D + W) * 4, against the bitonic
// network's N log2 N (log2 N + 1) / 4 compare-exchanges (a min and a max
// each) per window of a worker with neighbours, at 67 TFLOP/s: at W =
// 300, P = 6,922 (D = 299, N = 512) 11,520 a window, 48 GFLOP, 0.71 ms,
// against 25 MB of bytes (7.5 us) -- operations bind it, and shared
// memory's bandwidth (two loads and two stores per compare-exchange) is
// what the network really spends.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int D_PAD, bool kMedian>
__global__ void robust_gossip_kernel(const float* __restrict__ x,
                                     const float* __restrict__ t,
                                     const int* __restrict__ nbr,
                                     const int* __restrict__ deg,
                                     float* __restrict__ y, int P,
                                     int nbr_stride, float b_frac,
                                     int b_abs) {
  constexpr int N = D_PAD + 1;
  const int i = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= P) return;
  const int64_t at = (int64_t)i * P + c;
  const int d = min(deg[i], nbr_stride);
  const float own = x[at];
  if (d <= 0) {
    y[at] = own;
    return;
  }
  float v[N];
  v[0] = own;
#pragma unroll
  for (int k = 0; k < D_PAD; ++k) {
    v[k + 1] = k < d ? t[(int64_t)nbr[(int64_t)i * nbr_stride + k] * P + c]
                     : INFINITY;
  }
  // odd-even transposition sort: N passes, pass p compare-exchanging the
  // pairs (r, r + 1) with r = p mod 2, p mod 2 + 2, ...
#pragma unroll
  for (int p = 0; p < N; ++p) {
#pragma unroll
    for (int r = p & 1; r + 1 < N; r += 2) {
      const float lo = fminf(v[r], v[r + 1]);
      const float hi = fmaxf(v[r], v[r + 1]);
      v[r] = lo;
      v[r + 1] = hi;
    }
  }
  const int cnt = d + 1;
  float out;
  if (kMedian) {
    const int lo = (cnt - 1) / 2, hi = cnt / 2;
    float vlo = 0.f, vhi = 0.f;
#pragma unroll
    for (int p = 0; p < N; ++p) {
      if (p == lo) vlo = v[p];
      if (p == hi) vhi = v[p];
    }
    out = __fmul_rn(0.5f, __fadd_rn(vlo, vhi));
  } else {
    int bi = b_abs >= 0 ? b_abs : (int)floorf(__fmul_rn(b_frac, (float)cnt));
    bi = min(bi, (cnt - 1) / 2);
    float acc = 0.f;
#pragma unroll
    for (int p = 0; p < N; ++p) {
      if (p >= bi && p < cnt - bi) acc = __fadd_rn(acc, v[p]);
    }
    out = __fdiv_rn(acc, (float)(cnt - 2 * bi));
  }
  y[at] = out;
}

// ---------------------------------------------------------------------------
// the wide instance: D > 64, the window in shared memory
// ---------------------------------------------------------------------------

constexpr int kWideThreads = 256;
constexpr int kWideMaxCols = 128;
constexpr int kWideTwoBlockBytes = 96 * 1024;
constexpr int kWideMaxN = 32768;       // one column's window: 128 KB

__host__ __device__ constexpr int wide_cols(int n) {
  int c = kWideMaxCols;
  while (c > 1 && (size_t)n * c * 4 > (size_t)kWideTwoBlockBytes) c >>= 1;
  return c;
}

__device__ __forceinline__ int pow2_at_least(int v) {
  int n = 1;
  while (n < v) n <<= 1;
  return n;
}

template <bool kMedian>
__global__ void __launch_bounds__(kWideThreads)
robust_gossip_wide_kernel(const float* __restrict__ x,
                          const float* __restrict__ t,
                          const int* __restrict__ nbr,
                          const int* __restrict__ deg,
                          float* __restrict__ y, int P, int nbr_stride,
                          int c_shift, float b_frac, int b_abs) {
  extern __shared__ float win[];       // [N][C], column c at stride C
  const int C = 1 << c_shift;
  const int i = blockIdx.y;
  const int c0 = blockIdx.x * C;
  const int tid = threadIdx.x;
  // a thread keeps one column c and walks rows r0, r0 + R, ... of it
  const int c = tid & (C - 1), r0 = tid >> c_shift;
  const int R = kWideThreads >> c_shift;
  const int col = c0 + c;
  const int64_t row = (int64_t)i * P;
  const int d = min(deg[i], nbr_stride);
  if (d <= 0) {                        // keeps its row (block-uniform)
    if (r0 == 0 && col < P) y[row + col] = x[row + col];
    return;
  }
  const int cnt = d + 1;
  const int N = pow2_at_least(cnt);
  const int* nrow = nbr + (int64_t)i * nbr_stride;
  for (int k = r0; k < N; k += R) {
    float val = INFINITY;
    if (k < cnt && col < P) {
      val = k == 0 ? x[row + col] : t[(int64_t)__ldg(nrow + k - 1) * P + col];
    }
    win[(k << c_shift) + c] = val;
  }
  __syncthreads();
  // bitonic network: merge sizes 2, 4, ..., N; pair (lo, lo + j) of a
  // stage ascending where lo's bit `size` is clear (always at size N)
  for (int size = 2; size <= N; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      for (int q = r0; q < N / 2; q += R) {
        const int lo = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        const bool up = (lo & size) == 0;
        float* a = win + (lo << c_shift) + c;
        float* b = a + (j << c_shift);
        const float va = *a, vb = *b;
        const float mn = fminf(va, vb), mx = fmaxf(va, vb);
        *a = up ? mn : mx;
        *b = up ? mx : mn;
      }
      __syncthreads();
    }
  }
  if (r0 != 0 || col >= P) return;
  float out;
  if (kMedian) {
    const int lo = (cnt - 1) / 2, hi = cnt / 2;
    out = __fmul_rn(0.5f, __fadd_rn(win[(lo << c_shift) + c],
                                    win[(hi << c_shift) + c]));
  } else {
    int bi = b_abs >= 0 ? b_abs : (int)floorf(__fmul_rn(b_frac, (float)cnt));
    bi = min(bi, (cnt - 1) / 2);
    float acc = 0.f;
    for (int p = bi; p < cnt - bi; ++p)
      acc = __fadd_rn(acc, win[(p << c_shift) + c]);
    out = __fdiv_rn(acc, (float)(cnt - 2 * bi));
  }
  y[row + col] = out;
}

template <bool kMedian>
cudaError_t launch_wide(const float* x, const float* t, const int* nbr,
                        const int* deg, float* y, int W, int P,
                        int nbr_stride, float b_frac, int b_abs,
                        cudaStream_t stream) {
  int n = 1;
  while (n < nbr_stride + 1) n <<= 1;
  if (n > kWideMaxN) return cudaErrorInvalidValue;
  static bool opted_in = false;        // once per instance and process
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        robust_gossip_wide_kernel<kMedian>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kWideMaxN * 4);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const int cols = wide_cols(n);
  int c_shift = 0;
  while ((1 << c_shift) < cols) ++c_shift;
  const size_t smem = (size_t)n * cols * sizeof(float);
  const dim3 grid((P + cols - 1) / cols, W);
  robust_gossip_wide_kernel<kMedian><<<grid, kWideThreads, smem, stream>>>(
      x, t, nbr, deg, y, P, nbr_stride, c_shift, b_frac, b_abs);
  return cudaGetLastError();
}

template <int D_PAD>
cudaError_t launch(bool median, const float* x, const float* t,
                   const int* nbr, const int* deg, float* y, int W, int P,
                   int nbr_stride, float b_frac, int b_abs,
                   cudaStream_t stream) {
  const dim3 grid((P + kThreads - 1) / kThreads, W);
  if (median) {
    robust_gossip_kernel<D_PAD, true><<<grid, kThreads, 0, stream>>>(
        x, t, nbr, deg, y, P, nbr_stride, b_frac, b_abs);
  } else {
    robust_gossip_kernel<D_PAD, false><<<grid, kThreads, 0, stream>>>(
        x, t, nbr, deg, y, P, nbr_stride, b_frac, b_abs);
  }
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`, allocates nothing, and returns a cudaError_t as
// an int (0 == success). d_pad: the register instance, a power of two in
// 1..64 with d_pad >= nbr_stride (the table's D), or 0 for the wide
// instance (D up to 32,767; cudaErrorInvalidValue past it). mode 0 =
// trimmed, 1 = median. b_abs >= 0 is an absolute trim count; b_abs < 0
// means floor(b_frac * cnt). The caller checks shapes, dtypes, devices
// and W <= 65535 (grid y).
extern "C" int robust_gossip_f32(const float* x, const float* t,
                                 const int* nbr, const int* deg, float* y,
                                 int W, int P, int nbr_stride, int d_pad,
                                 int mode, float b_frac, int b_abs,
                                 void* stream) {
  if (W == 0 || P == 0) return 0;
  const bool median = mode == 1;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (d_pad) {
    case 0:
      return median ? launch_wide<true>(x, t, nbr, deg, y, W, P, nbr_stride,
                                        b_frac, b_abs, s)
                    : launch_wide<false>(x, t, nbr, deg, y, W, P,
                                         nbr_stride, b_frac, b_abs, s);
    case 1: return launch<1>(median, x, t, nbr, deg, y, W, P, nbr_stride,
                             b_frac, b_abs, s);
    case 2: return launch<2>(median, x, t, nbr, deg, y, W, P, nbr_stride,
                             b_frac, b_abs, s);
    case 4: return launch<4>(median, x, t, nbr, deg, y, W, P, nbr_stride,
                             b_frac, b_abs, s);
    case 8: return launch<8>(median, x, t, nbr, deg, y, W, P, nbr_stride,
                             b_frac, b_abs, s);
    case 16: return launch<16>(median, x, t, nbr, deg, y, W, P, nbr_stride,
                               b_frac, b_abs, s);
    case 32: return launch<32>(median, x, t, nbr, deg, y, W, P, nbr_stride,
                               b_frac, b_abs, s);
    case 64: return launch<64>(median, x, t, nbr, deg, y, W, P, nbr_stride,
                               b_frac, b_abs, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
