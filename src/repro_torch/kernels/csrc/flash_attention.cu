// flash_attention: grouped-query attention forward with an online softmax,
// f32, causal and sliding-window masks.
//
//     o[b, s, h, :] = sum_t softmax_t(q[b, s, h, :] . k[b, t, h / g, :]
//                                     * hd^-0.5, masked) * v[b, t, h / g, :]
//
// q, o [B, S, Hq, hd] and k, v [B, Sk, Hkv, hd], contiguous row-major f32
// (the registry models' layout, no transposes); g = Hq / Hkv query heads
// share a KV head. Key t is in reach of query s when t < Sk, t <= s
// (causal) and t > s - window (window > 0); out-of-reach scores are -1e30,
// as in the reference. The wrapper (repro_torch/kernels/ops.py) applies the
// reference's mask rules and requires S <= Sk, so every query has a key in
// reach.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_fwd (:77, body _attn_kernel), which the reference
// reaches through repro/kernels/ops.py:flash_attention in every forward
// pass of a registry model with use_flash_kernel set. That kernel walks a
// sequential (batch, head, q-block, kv-block) grid with the running max,
// denominator and accumulator in VMEM scratch, on blocks padded to 128
// rows. Here a block owns its query rows and loops over the keys itself,
// so nothing carries between blocks, and the ragged ends of S and Sk are
// masked in the kernel instead of padded.
//
// Two instances, chosen by the caller (repro_torch/kernels/ops.py:
// flash_instance) and passed in as `short_path`:
//
// * The short-sequence kernel, for Sk <= 64 (kShortMaxKeys) when q, k, v
//   and o are 16-byte aligned: the DFL path's 16-token sequences (S = Sk
//   = 15). One block per (sequence b, KV head, chunk of 64 query rows);
//   the rows are the g * S (position, head) pairs of the KV group,
//   position-major (row r is position r / g of head r % g), so a warp's
//   rows sit at nearly the same position and reach nearly the same keys.
//   Nothing is padded: the block has ceil(rows * 4 / 32) warps (6 for the
//   45 rows at S = 15, g = 3), and a warp past the last row leaves after
//   the staging barrier. The group's K and V (Sk x hd each, 7.7 KB at S =
//   15, hd 64) go to shared memory with 16-byte cp.async; each query row
//   belongs to a quad of threads that splits hd in float4 chunks
//   interleaved four apart (thread j owns chunks j, j + 4, ...), so the
//   quad reads 64 contiguous bytes of a K or V row from shared memory and
//   every quad of the warp reads the same key (a broadcast). A thread
//   loads its slice of q from global memory straight into registers
//   (float4), keeps its slice of the accumulator there, and writes it
//   with float4 stores. The warp walks the keys from the first its rows
//   can reach to the last; per key the quad adds its four partial dot
//   products with two xor shuffles, and a row whose key is in reach
//   updates its running max, denominator and accumulator (rescaled only
//   when the max rises) -- no score tile, no expf on a masked entry.
//   Shared memory is 2 * Sk * hd * 4 bytes (32 KB at Sk = 64, hd 64;
//   96 KB at hd 192, opted in above the 48 KB default). The limit is 64
//   keys at every head width: at Sk = 64 the short kernel ran 1.75x
//   (hd 64), 3.2x (hd 128) and 3.0x (hd 192) faster than the tile kernel
//   on an H100 SXM at 700 W (tools/kernel_ab.py).
// * The tile kernel, for longer Sk: one block of 256 threads per
//   (sequence b, KV head, tile of 64 query rows) of the group's heads,
//   packed head-major. Per key tile of 64 rows: Q (staged once), K and V
//   sit in shared memory, rows padded by one float against bank
//   conflicts; thread (ty, tx) of a 16 x 16 arrangement computes the
//   scores of rows ty + 16 i and keys tx + 16 j (i, j < 4; only the j
//   that reach an existing key); four threads per row then take the row's
//   max and sum with two xor shuffles and write p = exp(s - m) back; the
//   same thread arrangement owns the accumulator of rows ty + 16 i and
//   columns tx + 16 c (c < hd / 16) in registers, and adds p v over the
//   tile's existing keys only. Key tiles wholly outside every row's causal
//   / window reach are skipped: their weights are exact zeros in the
//   reference too (exp(-1e30 - m) = 0, or erased by alpha = exp(-1e30 - m)
//   = 0 when they came first). Shared memory: (3 * 64 * (hd + 1) + 64 * 65
//   + 128) floats -- 67 KB at hd = 64, 166 KB at hd = 192.
//
// Blocks go on gridDim.x (B * Hkv * ceil(g * S / 64) for both: 81,920
// for the whole measurement stack in one launch, past the 65,535 of the
// y axis).
//
// What held the tile kernel back at S = 15, and why the short kernel
// exists: a block staged a 64-row query tile holding 45 live rows and
// zero-filled 64-row K and V tiles holding 15 live keys, wrote a 64 x 65
// score tile and ran expf on all 64 x 64 entries, of which 360 are live
// under the causal mask; 67 KB of shared memory a block allowed 3 blocks
// per SM; and its scalar 4-byte loads came in phases between four
// barriers a tile, so an SM waited on memory and then computed while
// memory sat idle. It reached 21% of its byte bound there.
//
// Precision: expf (not __expf), IEEE division, no --use_fast_math. The
// online softmax reassociates the reference's sums, so both instances
// are held to 2e-5 against the plain version, not bit for bit.
//
// Bound: q, k and v read once and o written once; 4 B Hq S Sk_eff hd
// operations (two products, Sk_eff the keys in reach, about Sk / 2 under
// a causal mask). At the DFL path's S = 15 a (sequence, KV head) group
// does about 3 operations a byte, far below the f32 ridge of about 20,
// so bytes bound it; tensor cores would not help there, which is why the
// short kernel computes with scalar FMAs and spends its design on keeping
// loads in flight (many small blocks per SM, asynchronous copies, no
// padding). At S = 4,096 the operations bound it, against the 67 TFLOP/s
// f32 rate: the tile kernel's scalar FMAs from shared memory reach 20-30%
// of that; tensor cores (3xTF32 to hold 2e-5) are later work.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // query rows a block
constexpr int kKeys = 64;      // key rows a tile
constexpr int kThreads = 256;
constexpr int kLdP = kKeys + 1;
constexpr float kNegInf = -1e30f;

__host__ __device__ constexpr size_t smem_floats(int hd) {
  return 3 * (size_t)kRows * (hd + 1) + (size_t)kRows * kLdP + 2 * kRows;
}

// sc[i][j] += q[ty + 16 i] . k[tx + 16 j] for j < NJ, from shared memory
template <int HD, int NJ>
__device__ __forceinline__ void tile_scores(const float* sq, const float* sk,
                                            int ty, int tx,
                                            float (&sc)[4][4]) {
  constexpr int LD = HD + 1;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float qv[4], kv[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = sq[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < NJ; ++j) kv[j] = sk[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) sc[i][j] += qv[i] * kv[j];
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int Sk, int Hq, int Hkv, int tiles, int causal, int window,
                 float scale) {
  constexpr int LD = HD + 1;
  constexpr int NC = HD / 16;          // accumulator columns a thread
  extern __shared__ float smem[];
  float* sq = smem;                    // [kRows][LD]
  float* sk = sq + kRows * LD;         // [kKeys][LD]
  float* sv = sk + kKeys * LD;         // [kKeys][LD]
  float* sp = sv + kKeys * LD;         // [kRows][kLdP] scores, then p
  float* s_alpha = sp + kRows * kLdP;  // [kRows]
  float* s_l = s_alpha + kRows;        // [kRows]

  const int g = Hq / Hkv;
  const int rows_total = g * S;
  int64_t bid = blockIdx.x;
  const int tile = (int)(bid % tiles);
  bid /= tiles;
  const int kvh = (int)(bid % Hkv);
  const int64_t b = bid / Hkv;
  const int r0 = tile * kRows;
  const int tid = threadIdx.x;

  // the tile's query rows: row r is (head kvh * g + r / S, position r % S)
  for (int idx = tid; idx < kRows * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD, row = r0 + r;
    float val = 0.f;
    if (row < rows_total) {
      const int gi = row / S, s = row % S;
      val = q[((b * S + s) * Hq + kvh * g + gi) * HD + d];
    }
    sq[r * LD + d] = val;
  }

  // the key range any row of the tile can reach
  const int r_last = min(r0 + kRows, rows_total) - 1;
  int s_min = 0, s_max = S - 1;
  if (r0 / S == r_last / S) {
    s_min = r0 % S;
    s_max = r_last % S;
  }
  const int k_hi = causal ? min(s_max, Sk - 1) : Sk - 1;
  const int k_lo = window ? max(0, s_min - window + 1) : 0;

  const int ty = tid >> 4, tx = tid & 15;
  int pos[4];                          // the positions of rows ty + 16 i
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    pos[i] = row < rows_total ? row % S : S - 1;
  }
  const int srow = tid >> 2, sub = tid & 3;   // softmax: 4 threads a row
  float m_run = kNegInf, l_run = 0.f;
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  for (int kt = k_lo / kKeys; kt <= k_hi / kKeys; ++kt) {
    const int j0 = kt * kKeys;
    __syncthreads();                   // the last tile's readers are done
    for (int idx = tid; idx < kKeys * HD; idx += kThreads) {
      const int j = idx / HD, d = idx % HD, key = j0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < Sk) {
        const int64_t off = ((b * Sk + key) * Hkv + kvh) * HD + d;
        kv = k[off];
        vv = v[off];
      }
      sk[j * LD + d] = kv;
      sv[j * LD + d] = vv;
    }
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 16 j, j < ceil(nk / 16):
    // the tile's key columns past Sk are not computed (they stay 0 and
    // are masked below)
    const int nk = min(kKeys, Sk - j0);
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    if (nk <= 16) {
      tile_scores<HD, 1>(sq, sk, ty, tx, sc);
    } else if (nk <= 32) {
      tile_scores<HD, 2>(sq, sk, ty, tx, sc);
    } else if (nk <= 48) {
      tile_scores<HD, 3>(sq, sk, ty, tx, sc);
    } else {
      tile_scores<HD, 4>(sq, sk, ty, tx, sc);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = j0 + tx + 16 * j;
        const bool in_reach = key < Sk && (!causal || key <= pos[i]) &&
                              (!window || key > pos[i] - window);
        sp[(ty + 16 * i) * kLdP + tx + 16 * j] =
            in_reach ? sc[i][j] * scale : kNegInf;
      }
    __syncthreads();

    // online softmax of row srow over the tile's 64 keys
    float* prow = sp + srow * kLdP + sub * 16;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 16; ++j) mx = fmaxf(mx, prow[j]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float p = expf(prow[j] - m_new);
      prow[j] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float alpha = expf(m_run - m_new);
    l_run = l_run * alpha + sum;
    m_run = m_new;
    if (sub == 0) s_alpha[srow] = alpha;
    __syncthreads();

    // acc = acc * alpha + p @ v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = s_alpha[ty + 16 * i];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= a;
    }
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {       // keys past Sk have v = 0
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = sv[j * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sp[(ty + 16 * i) * kLdP + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] += p * vv[c];
      }
    }
  }

  if (sub == 0) s_l[srow] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, row = r0 + r;
    if (row >= rows_total) continue;
    const int gi = row / S, s = row % S;
    const float denom = fmaxf(s_l[r], 1e-30f);
    float* orow = o + ((b * S + s) * Hq + kvh * g + gi) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[tx + 16 * c] = acc[i][c] / denom;
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int S, int Sk, int Hq, int Hkv, int causal, int window,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(HD) * sizeof(float);
  static bool opted_in = false;        // once per instance and process
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const int rows = (Hq / Hkv) * S;
  const int tiles = (rows + kRows - 1) / kRows;
  const unsigned grid = (unsigned)((int64_t)B * Hkv * tiles);
  flash_fwd_kernel<HD><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, S, Sk, Hq, Hkv, tiles, causal, window, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the short-sequence kernel: Sk <= kShortMaxKeys
// ---------------------------------------------------------------------------

constexpr int kShortMaxKeys = 64;      // keys the group's K/V stage holds
constexpr int kShortRows = 64;         // query rows a block, at most
constexpr int kQuad = 4;               // threads a query row

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int HD>
__global__ void __launch_bounds__(kShortRows * kQuad)
flash_short_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o, int S,
                   int Sk, int Hq, int Hkv, int chunks, int causal,
                   int window, float scale) {
  constexpr int H4 = HD / 4;           // float4s a row
  constexpr int NC = H4 / kQuad;       // float4s a thread
  extern __shared__ float4 smem4[];
  float4* sk = smem4;                  // [Sk][H4]
  float4* sv = sk + Sk * H4;           // [Sk][H4]

  const int g = Hq / Hkv;
  const int rows_total = g * S;
  int64_t bid = blockIdx.x;
  const int chunk = (int)(bid % chunks);
  bid /= chunks;
  const int kvh = (int)(bid % Hkv);
  const int64_t b = bid / Hkv;
  const int tid = threadIdx.x;

  // the group's K and V rows, 16 bytes a copy, all in flight at once
  const float4* k4 = reinterpret_cast<const float4*>(k);
  const float4* v4 = reinterpret_cast<const float4*>(v);
  for (int i = tid; i < Sk * H4; i += blockDim.x) {
    const int t = i / H4, c = i % H4;
    const int64_t off = ((b * Sk + t) * Hkv + kvh) * H4 + c;
    cp_async16(sk + i, k4 + off);
    cp_async16(sv + i, v4 + off);
  }

  // this thread's row (position-major) and slice of hd; rows past the
  // last read the last row's q and write nothing
  const int sub = tid & (kQuad - 1);
  const int r0 = chunk * kShortRows;
  const int r = r0 + tid / kQuad;
  const int row = min(r, rows_total - 1);
  const int s = row / g;
  const int64_t qoff = ((b * S + s) * Hq + kvh * g + row % g) * H4 + sub;
  const float4* qrow = reinterpret_cast<const float4*>(q) + qoff;
  float4 qv[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) qv[c] = __ldg(qrow + kQuad * c);
  cp_async_wait_all();
  __syncthreads();

  // the keys any row of this warp can reach (rows are position-major, so
  // its first and last rows hold its least and greatest positions)
  const int w_first = r0 + (tid & ~31) / kQuad;
  if (w_first >= rows_total) return;   // a warp wholly past the rows
  const int w_last = min(w_first + 32 / kQuad, rows_total) - 1;
  const int t_lo = window ? max(0, w_first / g - window + 1) : 0;
  const int t_hi = causal ? w_last / g : Sk - 1;

  float m = -CUDART_INF_F, l = 0.f;
  float4 acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t = t_lo; t <= t_hi; ++t) {
    const float4* kr = sk + t * H4 + sub;
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) dot = dot4(qv[c], kr[kQuad * c], dot);
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    dot += __shfl_xor_sync(0xffffffffu, dot, 2);
    const bool in_reach = (!causal || t <= s) && (!window || t > s - window);
    if (!in_reach) continue;
    const float sc = dot * scale;
    float p = 1.f;
    if (sc > m) {                      // a new max: rescale what is summed
      const float alpha = expf(m - sc);
      l *= alpha;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[c].x *= alpha;
        acc[c].y *= alpha;
        acc[c].z *= alpha;
        acc[c].w *= alpha;
      }
      m = sc;
    } else {
      p = expf(sc - m);
    }
    l += p;
    const float4* vr = sv + t * H4 + sub;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 vv = vr[kQuad * c];
      acc[c].x = fmaf(p, vv.x, acc[c].x);
      acc[c].y = fmaf(p, vv.y, acc[c].y);
      acc[c].z = fmaf(p, vv.z, acc[c].z);
      acc[c].w = fmaf(p, vv.w, acc[c].w);
    }
  }
  if (r >= rows_total) return;
  float4* orow = reinterpret_cast<float4*>(o) + qoff;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    orow[kQuad * c] = make_float4(acc[c].x / l, acc[c].y / l, acc[c].z / l,
                                  acc[c].w / l);
  }
}

template <int HD>
int launch_short(const float* q, const float* k, const float* v, float* o,
                 int B, int S, int Sk, int Hq, int Hkv, int causal,
                 int window, float scale, cudaStream_t stream) {
  if (Sk > kShortMaxKeys) return (int)cudaErrorInvalidValue;
  static bool opted_in = false;        // once per instance and process
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_short_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(2 * kShortMaxKeys * HD * sizeof(float)));
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const int rows = (Hq / Hkv) * S;
  const int chunks = (rows + kShortRows - 1) / kShortRows;
  const int threads = (min(rows, kShortRows) * kQuad + 31) / 32 * 32;
  const size_t smem = 2 * (size_t)Sk * HD * sizeof(float);
  const unsigned grid = (unsigned)((int64_t)B * Hkv * chunks);
  flash_short_kernel<HD><<<grid, threads, smem, stream>>>(
      q, k, v, o, S, Sk, Hq, Hkv, chunks, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`, allocates nothing, and returns a cudaError_t as an
// int (0 == success; cudaErrorInvalidValue for a head dim without an
// instance, or the short kernel asked for Sk > 64). The caller picks the
// instance (`short_path`: Sk <= 64 and q, k, v, o 16-byte aligned) and
// checks shapes, dtypes, devices, Hq % Hkv == 0, S <= Sk and
// B * Hkv * ceil(g * S / 64) < 2**31.
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* o, int B, int S,
                                   int Sk, int Hq, int Hkv, int hd,
                                   int causal, int window, int short_path,
                                   float scale, void* stream) {
  if (B == 0 || S == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (short_path) {
    switch (hd) {
      case 64:
        return launch_short<64>(q, k, v, o, B, S, Sk, Hq, Hkv, causal,
                                window, scale, st);
      case 128:
        return launch_short<128>(q, k, v, o, B, S, Sk, Hq, Hkv, causal,
                                 window, scale, st);
      case 192:
        return launch_short<192>(q, k, v, o, B, S, Sk, Hq, Hkv, causal,
                                 window, scale, st);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  switch (hd) {
    case 64:
      return launch<64>(q, k, v, o, B, S, Sk, Hq, Hkv, causal, window,
                        scale, st);
    case 128:
      return launch<128>(q, k, v, o, B, S, Sk, Hq, Hkv, causal, window,
                         scale, st);
    case 192:
      return launch<192>(q, k, v, o, B, S, Sk, Hq, Hkv, causal, window,
                         scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
