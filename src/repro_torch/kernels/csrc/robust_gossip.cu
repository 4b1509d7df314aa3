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
// an int (0 == success). d_pad: the template instance, a power of two in
// 1..64 with d_pad >= nbr_stride (the table's D). mode 0 = trimmed, 1 =
// median. b_abs >= 0 is an absolute trim count; b_abs < 0 means
// floor(b_frac * cnt). The caller checks shapes, dtypes, devices and
// W <= 65535 (grid y).
extern "C" int robust_gossip_f32(const float* x, const float* t,
                                 const int* nbr, const int* deg, float* y,
                                 int W, int P, int nbr_stride, int d_pad,
                                 int mode, float b_frac, int b_abs,
                                 void* stream) {
  if (W == 0 || P == 0) return 0;
  const bool median = mode == 1;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (d_pad) {
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
