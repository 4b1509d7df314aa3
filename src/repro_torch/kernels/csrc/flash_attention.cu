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
// flash_attention_fwd (body _attn_kernel), which the reference reaches
// through repro/kernels/ops.py:flash_attention in every forward pass of a
// registry model with use_flash_kernel set. That kernel walks a sequential
// (batch, head, q-block, kv-block) grid with the running max, denominator
// and accumulator in VMEM scratch, on blocks padded to 128 rows. Here a
// block owns its query rows and loops over the key tiles itself, so
// nothing carries between blocks, and the ragged ends of S and Sk are
// masked in the kernel instead of padded.
//
// Design: one block of 256 threads per (sequence b, KV head, tile of 64
// query rows). The rows of a tile are the g * S (head, position) pairs of
// the KV group, head-major, so the g heads that share a KV head share
// its K/V tiles -- at the DFL path's S = 15, g = 3 a tile holds 45 live
// rows where one row per (head, position) tile would hold 15. Blocks go
// on gridDim.x (B * Hkv * tiles: 81,920 for the whole measurement stack
// in one launch, past the 65,535 of the y axis). Per key tile of 64 rows: Q (staged once), K
// and V sit in shared memory, rows padded by one float against bank
// conflicts; thread (ty, tx) of a 16 x 16 arrangement computes the scores
// of rows ty + 16 i and keys tx + 16 j (i, j < 4; only the j that reach
// an existing key, so a tile of S = 15 keys computes a quarter of them);
// four threads per row then take the row's max and sum with two xor
// shuffles and write p = exp(s - m) back; the same thread arrangement
// owns the accumulator of rows ty + 16 i and columns tx + 16 c
// (c < hd / 16) in registers, and adds p v over the tile's existing keys
// only. Key
// tiles wholly outside every row's causal / window reach are skipped:
// their weights are exact zeros in the reference too (exp(-1e30 - m) = 0,
// or erased by alpha = exp(-1e30 - m) = 0 when they came first).
// Shared memory: (3 * 64 * (hd + 1) + 64 * 65 + 128) floats -- 67 KB at
// hd = 64, 166 KB at hd = 192 -- opted in above the 48 KB default.
//
// Precision: expf (not __expf), IEEE division, no --use_fast_math. The
// online softmax reassociates the reference's sums, so it is held to
// 2e-5 against the plain version, not bit for bit.
//
// Bound: q, k and v read once and o written once; 4 B Hq S Sk_eff hd
// operations (two products, Sk_eff the keys in reach, about Sk / 2 under
// a causal mask). At the DFL path's S = 15 the bytes bound it; at
// S = 4,096 the operations, against the 67 TFLOP/s f32 rate (no tensor
// cores here: the first version computes with scalar FMAs from shared
// memory; wgmma and TMA are later work).

#include <cuda_runtime.h>
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

}  // namespace

// Launches on `stream`, allocates nothing, and returns a cudaError_t as an
// int (0 == success; cudaErrorInvalidValue for a head dim without an
// instance). The caller checks shapes, dtypes, devices, Hq % Hkv == 0,
// S <= Sk and B * Hkv * tiles < 2**31.
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* o, int B, int S,
                                   int Sk, int Hq, int Hkv, int hd,
                                   int causal, int window, float scale,
                                   void* stream) {
  if (B == 0 || S == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
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
