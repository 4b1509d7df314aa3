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
// (worker, column) window in registers (a block of 128 threads takes 128
// columns of one worker i = blockIdx.y), for tables of D_PAD neighbours
// (a template parameter, a power of two, 1..64; the fused engine pads
// each segment's neighbour table to one such D). A worker's degree is
// the same for every thread of its block, so each block picks, by a
// block-uniform switch on d = deg[i], a sort sized to its own window of
// cnt = d + 1 values: the S = the next power of two >= cnt slots (slots
// past cnt +inf) sorted by Batcher's odd-even merge sort; or, where d
// is itself a power of two (cnt one past it), the d neighbour values
// sorted by that network and the worker's own value inserted by one
// pass of d compare-exchanges that carries the larger value upward, so
// a window of 2^k + 1 does not pay for 2^(k+1) slots. A D_PAD kernel
// holds the sorts up to D_PAD slots only. The networks are unrolled from
// templates (every index a compile-time constant, so the window stays in
// registers): compare-exchanges with fminf / fmaxf, no data-dependent
// branch, so the warp stays in step. Compare-exchanges a window: 5 / 19
// / 63 / 191 / 543 at S = 4 / 8 / 16 / 32 / 64, 223 at cnt = 33 (191 +
// 32) and 607 at 65 -- against the transposition network's 528 on 33
// slots and 2,080 on 65 that the first version ran whatever the degree.
// Any correct sort puts the same values in the same positions; the sum
// then adds the window in ascending position order (__fadd_rn) and
// divides with __fdiv_rn, the plain version's order (repro_torch/
// kernels/ref.py:robust_gossip_ref), so the two agree bit for bit. The
// median reads its two positions by a tree of selects over the few a
// size class allows, and the trimmed sum tests a position against b_i
// and cnt - b_i only where the class leaves the test open: a select per
// position (the first version's) cost as much as a tenth of the sort.
// 128-thread blocks ran 6-9% faster than 256 at W = 30 (more, smaller
// blocks even out the last wave; tools/kernel_ab.py).
//
// Bound: the function reads x, t and the table once and writes y once:
// (3 W P + W D + W) * 4 bytes -- 2.49 MB at W = 30, P = 6922 (0.74 us at
// 3.35 TB/s), 170.1 MB at the W = 2,048 ring (50.8 us). Its operations
// are the compare-exchanges that sorting each window of its own cnt =
// d + 1 values needs, counted as Batcher's odd-even merge sort on cnt (a
// min and a max each): 162 for a window of 28, 63 MFLOP at W = 30 (28
// such windows), P = 6922: 0.94 us at 67 TFLOP/s, against this
// instance's 191 on 32 slots. So at W = 30 operations bind it, barely;
// at the ring's windows of 3 bytes do.
//
// Each neighbour row of t is read once per worker that lists it (from L2
// at these sizes). A later version could stage t's column tile in shared
// memory.
//
// Past 64 neighbours (a fleet of more than 65 workers on a dense base, or
// a hub of degree 65 or more) a register window per thread stops: 129
// floats a thread for D_PAD = 128 would spill, and an unrolled network of
// that size is some 8,000 instructions. The same Pallas kernel has no
// limit on D (d_pad = max(D, 1)); two more instances cover it here. Both
// launch one block of 256 threads per (worker i, a tile of C consecutive
// columns), stage worker i's window {x[i, c]} U {t[nbr[i, k], c] : k <
// deg[i]} in dynamic shared memory as N rows of C floats (N = the next
// power of two >= deg[i] + 1, each block its own N; the rows past the
// window +inf), and sort every column with a bitonic network. A thread
// stages one column c = tid mod C and the rows tid / C, tid / C + 256 /
// C, ... of it, with shifts (C is a power of two; an index divided by a
// C known only at run time made the first wide version 2-4x slower), so
// a warp reads 32 consecutive columns of one neighbour's row, coalesced.
// After the sort, the thread of row 0 of column c adds the column's
// positions [b_i, cnt - b_i) in ascending order with __fadd_rn and
// divides with __fdiv_rn (the median: 0.5 (v[lo] + v[hi])): the plain
// version's order, so both are bit-equal to it. C is the largest power
// of two <= 128 with N * C * 4 <= 96 KB, and 1 past that (N of 32,768
// takes 128 KB), with N the table's (the widest a block can have).
//
// The wide instance, for tables of D <= 1,023 (N <= 1,024): the network
// runs in registers and shuffles. A team of T lanes of one warp owns a
// column, lane t of it holding the window's positions t E .. t E + E - 1
// (E = N / T: T = N / 4 lanes of 4 values up to N = 64, 16 lanes of E =
// 8 and 16 at N = 128 and 256, 32 lanes of E = 16 and 32 at N = 512 and
// 1,024; a window of 2 or 4 is one lane's: the fastest of the layouts
// tools/kernel_ab.py timed on the card).
// Stages pairing positions less than E apart are compare-exchanges
// between a lane's registers (fminf / fmaxf, unrolled, E a template
// parameter); the rest one __shfl_xor_sync a value with the partner
// lane, whose min or max the lane keeps by its lane bit (team_sort: a
// lane holds its values negated while it is a stage's upper lane, so both
// keep a min, one instruction and no select). Nothing in the network
// touches shared memory or waits at a barrier: a lane reads its E values
// once and writes them back sorted. The staged rows are skewed by (r / E)
// * (32 / T) floats, so the lanes of a warp reading rows t E + e of their
// columns hit 32 different banks (unskewed, with C a multiple of 32, a
// team would hit one bank). The block first copies its worker's
// neighbour ids to shared memory, then issues every row's copy at once
// (cp.async), not one dependent load pair after another. One kernel per
// table width N (128, 256, 512, 1,024) holds the sorts up to it, so a
// narrow table's blocks do not carry the registers of E = 32. A warp's
// instructions per window: about N / 32 (2 x stages within a lane + 3 x
// stages across lanes) -- some 200 at N = 128 and 1,200 at N = 512 --
// so the instance is bound by issue (and the half-rate min/max pipe),
// not by shared memory.
//
// The shared instance, for tables of D >= 1,024 up to 32,767: the window
// no longer fits a warp's registers, so every stage goes through shared
// memory -- a thread walks rows tid / C, ... of its column, a stage's
// pair (lo, lo + j) at lo * C + c (consecutive columns in a warp, free of
// bank conflicts for C >= 32), a __syncthreads between stages. The
// limit: one column's window must fit a block's shared memory (227 KB),
// so N <= 32,768 and D <= 32,767 (ROBUST_SHARED_MAX_DEGREE in ops.py);
// 65,536 floats are 256 KB.
//
// Bound of both: the same bytes, (3 W P + W D + W) * 4, against the
// compare-exchanges that sorting each window of cnt values needs
// (Batcher's odd-even merge sort on cnt, not the bitonic network on N
// these instances run), a min and a max each, at 67 TFLOP/s: at W = 300,
// P = 6,922 (D = 299) 5,417 a window of 300 against the network's 11,520
// on 512, 22 GFLOP, 0.33 ms, against 25 MB of bytes (7.5 us) --
// operations bind it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;     // the register instance's block

// ---------------------------------------------------------------------------
// the register instance: a thread's window sorted by a network of its
// block's own size
// ---------------------------------------------------------------------------

__device__ __forceinline__ void compare_exchange(float& a, float& b) {
  const float lo = fminf(a, b);
  b = fmaxf(a, b);
  a = lo;
}

// Batcher's odd-even merge of the sorted halves of positions LO..HI
// (inclusive, a power of two of them), of the positions R apart: the
// even and the odd ones merged alone, then each odd one compared with
// the one R past it
template <int LO, int HI, int R, int S>
__device__ __forceinline__ void odd_even_merge(float (&v)[S]) {
  if constexpr (2 * R < HI - LO) {
    odd_even_merge<LO, HI, 2 * R>(v);
    odd_even_merge<LO + R, HI, 2 * R>(v);
#pragma unroll
    for (int i = LO + R; i < HI - R; i += 2 * R) {
      compare_exchange(v[i], v[i + R]);
    }
  } else {
    compare_exchange(v[LO], v[LO + R]);
  }
}

// Batcher's odd-even merge sort of positions LO..HI of v (inclusive, a
// power of two of them), ascending
template <int LO, int HI, int S>
__device__ __forceinline__ void odd_even_sort(float (&v)[S]) {
  if constexpr (HI > LO) {
    constexpr int MID = LO + (HI - LO) / 2;
    odd_even_sort<LO, MID>(v);
    odd_even_sort<MID + 1, HI>(v);
    odd_even_merge<LO, HI, 1>(v);
  }
}

// v[k] for a block-uniform k in [LO, LO + N), by a tree of selects on
// compile-time positions (a run-time index would send v to local memory)
template <int LO, int N, int S>
__device__ __forceinline__ float pick(const float (&v)[S], int k) {
  if constexpr (N == 1) {
    return v[LO];
  } else {
    constexpr int H = N / 2;
    return k < LO + H ? pick<LO, H>(v, k) : pick<LO + H, N - H>(v, k);
  }
}

// The trimmed mean (positions [b_i, cnt - b_i) added in ascending order)
// or the median of a sorted window of cnt values, CMIN <= cnt <= S (the
// window sizes its sort takes): positions are compile-time constants, so
// v stays in registers, and the tests CMIN and S decide are left out
template <int S, int CMIN, bool kMedian>
__device__ __forceinline__ float window_value(const float (&v)[S], int cnt,
                                              float b_frac, int b_abs) {
  if (kMedian) {
    constexpr int kLo = (CMIN - 1) / 2, kHi = CMIN / 2;
    const float vlo = pick<kLo, (S - 1) / 2 - kLo + 1>(v, (cnt - 1) / 2);
    const float vhi = pick<kHi, S / 2 - kHi + 1>(v, cnt / 2);
    return __fmul_rn(0.5f, __fadd_rn(vlo, vhi));
  }
  int bi = b_abs >= 0 ? b_abs : (int)floorf(__fmul_rn(b_frac, (float)cnt));
  bi = min(bi, (cnt - 1) / 2);
  const int end = cnt - bi;
  float acc = 0.f;
#pragma unroll
  for (int p = 0; p < S; ++p) {
    // bi <= (S - 1) / 2 and end > CMIN / 2 whatever cnt is
    if ((p > (S - 1) / 2 || p >= bi) && (p <= CMIN / 2 || p < end)) {
      acc = __fadd_rn(acc, v[p]);
    }
  }
  return __fdiv_rn(acc, (float)(cnt - 2 * bi));
}

// A window of d + 1 values, S / 2 + 1 < d + 1 <= S (S a power of two):
// the worker's own value and its d neighbours' in S slots, the rest
// +inf, sorted
template <int S, bool kMedian>
__device__ __forceinline__ float sort_window(float own,
                                             const float* __restrict__ t,
                                             const int* __restrict__ nrow,
                                             int d, int P, int c,
                                             float b_frac, int b_abs) {
  constexpr int kMinDegree = S / 2 + 1;
  float v[S];
  v[0] = own;
#pragma unroll
  for (int k = 0; k + 1 < S; ++k) {
    v[k + 1] = k < kMinDegree || k < d ? t[(int64_t)nrow[k] * P + c]
                                       : INFINITY;
  }
  odd_even_sort<0, S - 1>(v);
  return window_value<S, kMinDegree + 1, kMedian>(v, d + 1, b_frac, b_abs);
}

// A window of D + 1 values, D a power of two: the D neighbour values
// sorted, then the worker's own value inserted from the top slot by one
// pass of D compare-exchanges that carries the larger value upward
template <int D, bool kMedian>
__device__ __forceinline__ float insert_window(float own,
                                               const float* __restrict__ t,
                                               const int* __restrict__ nrow,
                                               int P, int c, float b_frac,
                                               int b_abs) {
  float v[D + 1];
#pragma unroll
  for (int k = 0; k < D; ++k) v[k] = t[(int64_t)nrow[k] * P + c];
  odd_even_sort<0, D - 1>(v);
  v[D] = own;
#pragma unroll
  for (int p = 0; p < D; ++p) compare_exchange(v[p], v[D]);
  return window_value<D + 1, D + 1, kMedian>(v, D + 1, b_frac, b_abs);
}

// One window of d >= 1 neighbours, by the sort for its size: S slots for
// S / 2 + 1 < d + 1 <= S, a power of two; a sort of d and an insertion
// where d is a power of two. Sizes past D_PAD are not instantiated.
template <int D_PAD, bool kMedian>
__device__ __forceinline__ float robust_window(float own,
                                               const float* __restrict__ t,
                                               const int* __restrict__ nrow,
                                               int d, int P, int c,
                                               float b_frac, int b_abs) {
#define ROBUST_INSERT(D)                                                   \
  if constexpr (D <= D_PAD) {                                             \
    if (d == D)                                                           \
      return insert_window<D, kMedian>(own, t, nrow, P, c, b_frac, b_abs); \
  }
#define ROBUST_SORT(S)                                                     \
  if constexpr (S <= D_PAD) {                                             \
    if (d < S)                                                            \
      return sort_window<S, kMedian>(own, t, nrow, d, P, c, b_frac, b_abs); \
  }
  ROBUST_INSERT(1)
  ROBUST_INSERT(2)
  ROBUST_SORT(4)
  ROBUST_INSERT(4)
  ROBUST_SORT(8)
  ROBUST_INSERT(8)
  ROBUST_SORT(16)
  ROBUST_INSERT(16)
  ROBUST_SORT(32)
  ROBUST_INSERT(32)
  ROBUST_SORT(64)
  ROBUST_INSERT(64)
#undef ROBUST_INSERT
#undef ROBUST_SORT
  return own;                          // d > D_PAD: not reached
}

template <int D_PAD, bool kMedian>
__global__ void robust_gossip_kernel(const float* __restrict__ x,
                                     const float* __restrict__ t,
                                     const int* __restrict__ nbr,
                                     const int* __restrict__ deg,
                                     float* __restrict__ y, int P,
                                     int nbr_stride, float b_frac,
                                     int b_abs) {
  const int i = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= P) return;
  const int64_t at = (int64_t)i * P + c;
  const int d = min(deg[i], nbr_stride);   // block-uniform
  const float own = x[at];
  y[at] = d <= 0 ? own
                 : robust_window<D_PAD, kMedian>(
                       own, t, nbr + (int64_t)i * nbr_stride, d, P, c,
                       b_frac, b_abs);
}

// ---------------------------------------------------------------------------
// past 64 neighbours: the window staged in shared memory
// ---------------------------------------------------------------------------

// the tables each instance takes, by width D (ROBUST_REGISTER_MAX_DEGREE
// and ROBUST_WIDE_MAX_DEGREE in ops.py, which name the instance a launch
// counts under)
constexpr int kRegisterMaxDegree = 64;
constexpr int kWideMaxDegree = 1023;
constexpr int kWideThreads = 256;
constexpr int kWideMaxCols = 128;
constexpr int kWideTwoBlockBytes = 96 * 1024;
constexpr int kSharedMaxN = 32768;     // one column's window: 128 KB
constexpr int kSkewFloats = 32;        // room for the wide instance's skew

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

// log2 E of the wide instance's team for a window of 2^log_n: one lane
// holds a window of 2 or 4, 4 values a lane up to 64, 16 lanes of 8 and
// 16 values at 128 and 256, then 32 lanes (E = 16, 32 at 512, 1,024)
__host__ __device__ constexpr int team_log_e(int log_n) {
  return log_n <= 2 ? log_n
                    : (log_n <= 6 ? 2 : (log_n <= 8 ? log_n - 4 : log_n - 5));
}

// Sorts one column's window of E * T values ascending. The team's T
// lanes are consecutive in the warp and all of them call; lane t (its
// index in the team) holds positions t E .. t E + E - 1 in v.
//
// Each merge of two sorted runs of s / 2 pairs a position r with its
// mirror r ^ (s - 1), then with r ^ j for j = s / 4 .. 1, the smaller
// value to the lower position, so no stage needs a direction. A stage
// with j < E pairs a lane's own registers. A stage with j >= E pairs lane
// t with lane t ^ (j / E) (a mirror stage: t ^ (s / E - 1), position e
// with the partner's E - 1 - e), the lower lane keeping the min and the
// upper the max. Across those stages a lane holds its values negated
// while it is the stage's upper lane (one multiply by +-1 an element
// between stages): then both lanes keep min(own, -partner's), which is
// the lower lane's min(v, v') and the upper's -max(v, v') -- one fminf
// with a negated operand, no select. The values get their signs back
// before the merge's stages within a lane.
template <int E, int T>
__device__ __forceinline__ void team_sort(float (&v)[E], int t) {
#pragma unroll
  for (int s = 2; s <= E * T; s <<= 1) {
    float sign = 1.0f;                 // the sign the lane's values hold
#pragma unroll
    for (int j = s >> 1; j > 0; j >>= 1) {
      const bool mirror = j == s >> 1;
      if (j < E) {
        const int m = mirror ? s - 1 : j;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int p = e ^ m;
          if (p > e) {
            const float lo = fminf(v[e], v[p]);
            v[p] = fmaxf(v[e], v[p]);
            v[e] = lo;
          }
        }
      } else {
        const int lanes = mirror ? s / E - 1 : j / E;
        const float upper = (t & (j / E)) ? -1.0f : 1.0f;
        const float flip = __fmul_rn(sign, upper);
        sign = upper;
#pragma unroll
        for (int e = 0; e < E; ++e) v[e] = __fmul_rn(v[e], flip);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (!mirror) {
            v[e] = fminf(v[e], -__shfl_xor_sync(0xffffffffu, v[e], lanes));
          } else if (e < E / 2) {      // e and E - 1 - e trade with the
            const int f = E - 1 - e;   // partner's f and e
            const float pe = __shfl_xor_sync(0xffffffffu, v[f], lanes);
            const float pf = __shfl_xor_sync(0xffffffffu, v[e], lanes);
            v[e] = fminf(v[e], -pe);
            v[f] = fminf(v[f], -pf);
          }
        }
        if (j == E) {                  // the last lane stage: signs back
#pragma unroll
          for (int e = 0; e < E; ++e) v[e] = __fmul_rn(v[e], sign);
        }
      }
    }
  }
}

// 4-byte asynchronous copy global -> shared, and the wait for all of a
// thread's copies
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The wide instance's sort of a block's C staged columns of 2^LOG_N rows:
// team k of the block takes columns k, k + 256 / T, ...; each lane reads
// its E rows of a column, sorts with its team and writes them back.
template <int LOG_N>
__device__ __forceinline__ void sort_columns(float* win, int C, int c_shift) {
  constexpr int kLogE = team_log_e(LOG_N);
  constexpr int E = 1 << kLogE, T = (1 << LOG_N) / E;
  constexpr int kSkewShift = 5 - (LOG_N - kLogE);  // 32 / T floats a group
  constexpr int kTeams = kWideThreads / T;
  const int t = threadIdx.x & (T - 1);
  for (int c = threadIdx.x / T; c < C; c += kTeams) {
    float* base = win + ((t * E) << c_shift) + c + (t << kSkewShift);
    float v[E];
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = base[e << c_shift];
    team_sort<E, T>(v, t);
#pragma unroll
    for (int e = 0; e < E; ++e) base[e << c_shift] = v[e];
  }
}

// One block's sort at its own window of 2^log_n <= 2^LOG_N_MAX rows: the
// launch's LOG_N_MAX (the table's) keeps the wider sorts, and their
// registers, out of the instances for narrower tables
template <int LOG_N_MAX>
__device__ __forceinline__ void sort_block(float* win, int log_n, int C,
                                           int c_shift) {
  switch (log_n) {                     // block-uniform
    case 1: sort_columns<1>(win, C, c_shift); break;
    case 2: sort_columns<2>(win, C, c_shift); break;
    case 3: sort_columns<3>(win, C, c_shift); break;
    case 4: sort_columns<4>(win, C, c_shift); break;
    case 5: sort_columns<5>(win, C, c_shift); break;
    case 6: sort_columns<6>(win, C, c_shift); break;
    case 7: sort_columns<7>(win, C, c_shift); break;
    case 8:
      if constexpr (LOG_N_MAX >= 8) sort_columns<8>(win, C, c_shift);
      break;
    case 9:
      if constexpr (LOG_N_MAX >= 9) sort_columns<9>(win, C, c_shift);
      break;
    default:
      if constexpr (LOG_N_MAX >= 10) sort_columns<10>(win, C, c_shift);
      break;
  }
}

template <int LOG_N_MAX, bool kMedian>
__global__ void __launch_bounds__(kWideThreads)
robust_gossip_wide_kernel(const float* __restrict__ x,
                          const float* __restrict__ t,
                          const int* __restrict__ nbr,
                          const int* __restrict__ deg,
                          float* __restrict__ y, int P, int nbr_stride,
                          int c_shift, float b_frac, int b_abs) {
  extern __shared__ float win[];       // [N][C] skewed, column c at stride C
  __shared__ int src[1 << LOG_N_MAX];  // the window's rows: neighbour ids
  const int C = 1 << c_shift;
  const int i = blockIdx.y;
  const int c0 = blockIdx.x * C;
  const int tid = threadIdx.x;
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
  const int N = pow2_at_least(cnt);    // this worker's window, 2 .. 1,024
  const int log_n = 31 - __clz(N);
  const int e_shift = team_log_e(log_n);
  const int skew_shift = 5 - (log_n - e_shift);
  // the neighbour ids once, then every row's copy in flight at once
  const int* nrow = nbr + (int64_t)i * nbr_stride;
  for (int k = tid; k < d; k += kWideThreads) src[k] = nrow[k];
  __syncthreads();
  for (int k = r0; k < N; k += R) {
    float* dst = win + (k << c_shift) + c + ((k >> e_shift) << skew_shift);
    if (k < cnt && col < P) {
      cp_async4(dst, k == 0 ? x + row + col
                            : t + (int64_t)src[k - 1] * P + col);
    } else {
      *dst = INFINITY;
    }
  }
  cp_async_wait_all();
  __syncthreads();
  sort_block<LOG_N_MAX>(win, log_n, C, c_shift);
  __syncthreads();
  if (r0 != 0 || col >= P) return;
  const float* wc = win + c;
  float out;
  if (kMedian) {
    const int lo = (cnt - 1) / 2, hi = cnt / 2;
    out = __fmul_rn(0.5f, __fadd_rn(
        wc[(lo << c_shift) + ((lo >> e_shift) << skew_shift)],
        wc[(hi << c_shift) + ((hi >> e_shift) << skew_shift)]));
  } else {
    int bi = b_abs >= 0 ? b_abs : (int)floorf(__fmul_rn(b_frac, (float)cnt));
    bi = min(bi, (cnt - 1) / 2);
    float acc = 0.f;
    for (int p = bi; p < cnt - bi; ++p) {
      acc = __fadd_rn(acc,
                      wc[(p << c_shift) + ((p >> e_shift) << skew_shift)]);
    }
    out = __fdiv_rn(acc, (float)(cnt - 2 * bi));
  }
  y[row + col] = out;
}

template <bool kMedian>
__global__ void __launch_bounds__(kWideThreads)
robust_gossip_shared_kernel(const float* __restrict__ x,
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

// One launch of the wide (kShared false) or the shared instance on a
// table of stride nbr_stride; cudaErrorInvalidValue where its window
// does not fit the instance.
typedef void (*StagedKernel)(const float*, const float*, const int*,
                             const int*, float*, int, int, int, float, int);

// One launch of `kernel` with windows of up to n rows (plus `extra`
// floats of dynamic shared memory); kId names the kernel, whose dynamic
// shared memory is opted in once per process to what its launches need
template <int kId>
cudaError_t launch_staged(StagedKernel kernel, int n, size_t extra,
                          const float* x, const float* t, const int* nbr,
                          const int* deg, float* y, int W, int P,
                          int nbr_stride, float b_frac, int b_abs,
                          cudaStream_t stream) {
  const int cols = wide_cols(n);
  int c_shift = 0;
  while ((1 << c_shift) < cols) ++c_shift;
  const size_t smem = ((size_t)n * cols + extra) * sizeof(float);
  static size_t opted_in = 0;
  if (opted_in < smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  const dim3 grid((P + cols - 1) / cols, W);
  kernel<<<grid, kWideThreads, smem, stream>>>(
      x, t, nbr, deg, y, P, nbr_stride, c_shift, b_frac, b_abs);
  return cudaGetLastError();
}

// the wide instance: its kernel for the table's N (128 to 1,024)
template <bool kMedian>
cudaError_t launch_wide(const float* x, const float* t, const int* nbr,
                        const int* deg, float* y, int W, int P,
                        int nbr_stride, float b_frac, int b_abs,
                        cudaStream_t stream) {
  int n = 128;                         // the narrowest kernel's N
  while (n < nbr_stride + 1) n <<= 1;
  switch (n) {
#define ROBUST_WIDE_CASE(LOG_N)                                           \
  case 1 << LOG_N:                                                        \
    return launch_staged<2 * LOG_N + kMedian>(                            \
        robust_gossip_wide_kernel<LOG_N, kMedian>, n, kSkewFloats, x, t,  \
        nbr, deg, y, W, P, nbr_stride, b_frac, b_abs, stream);
    ROBUST_WIDE_CASE(7)
    ROBUST_WIDE_CASE(8)
    ROBUST_WIDE_CASE(9)
    ROBUST_WIDE_CASE(10)
#undef ROBUST_WIDE_CASE
    default:
      return cudaErrorInvalidValue;    // a window past 1,024
  }
}

template <bool kMedian>
cudaError_t launch_shared(const float* x, const float* t, const int* nbr,
                          const int* deg, float* y, int W, int P,
                          int nbr_stride, float b_frac, int b_abs,
                          cudaStream_t stream) {
  int n = 1;
  while (n < nbr_stride + 1) n <<= 1;
  if (n > kSharedMaxN) return cudaErrorInvalidValue;
  return launch_staged<kMedian>(robust_gossip_shared_kernel<kMedian>, n, 0,
                                x, t, nbr, deg, y, W, P, nbr_stride, b_frac,
                                b_abs, stream);
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

// The launcher's argument list; the version before it took a d_pad
// between nbr_stride and mode (the register window, 0 past 64).
extern "C" int robust_gossip_abi() { return 2; }

// Launches on `stream`, allocates nothing, and returns a cudaError_t as
// an int (0 == success). The table's width nbr_stride (its D) picks the
// instance: register to kRegisterMaxDegree (the window rounded up to a
// power of two), wide to kWideMaxDegree, shared past it;
// cudaErrorInvalidValue past 32,767. mode 0 = trimmed, 1 = median.
// b_abs >= 0 is an absolute trim count; b_abs < 0 means
// floor(b_frac * cnt). The caller checks shapes, dtypes, devices and
// W <= 65535 (grid y).
extern "C" int robust_gossip_f32(const float* x, const float* t,
                                 const int* nbr, const int* deg, float* y,
                                 int W, int P, int nbr_stride, int mode,
                                 float b_frac, int b_abs, void* stream) {
  if (W == 0 || P == 0) return 0;
  const bool median = mode == 1;
  const cudaStream_t s = (cudaStream_t)stream;
  if (nbr_stride > kWideMaxDegree)
    return median ? launch_shared<true>(x, t, nbr, deg, y, W, P, nbr_stride,
                                        b_frac, b_abs, s)
                  : launch_shared<false>(x, t, nbr, deg, y, W, P,
                                         nbr_stride, b_frac, b_abs, s);
  if (nbr_stride > kRegisterMaxDegree)
    return median ? launch_wide<true>(x, t, nbr, deg, y, W, P, nbr_stride,
                                      b_frac, b_abs, s)
                  : launch_wide<false>(x, t, nbr, deg, y, W, P, nbr_stride,
                                       b_frac, b_abs, s);
  int d_pad = 1;
  while (d_pad < nbr_stride) d_pad <<= 1;
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
    default: return launch<64>(median, x, t, nbr, deg, y, W, P, nbr_stride,
                               b_frac, b_abs, s);
  }
}
