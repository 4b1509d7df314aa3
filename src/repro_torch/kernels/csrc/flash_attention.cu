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
// * The short-sequence kernel, for Sk up to the caller's limit (at most
//   64, kShortMaxKeys) when q, k, v and o are 16-byte aligned: the DFL
//   path's 16-token sequences (S = Sk = 15). One block per (sequence b,
//   KV head, chunk of 64 query rows); the rows are the g * S (position,
//   head) pairs of the KV group, position-major (row r is position r / g
//   of head r % g), so a warp's rows sit at nearly the same position and
//   reach nearly the same keys.
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
//   96 KB at hd 192, opted in above the 48 KB default). The caller's
//   limits (ops.FLASH_SHORT_MAX_KEYS: 48 keys at hd 64 and 192, 32 at
//   hd 128) sit where this kernel and the tensor-core tile kernel cross
//   on an H100 SXM at 700 W (tools/kernel_ab.py, Sk = 16 to 64); at
//   Sk = 64 the tile kernel now wins at every head width.
// * The tile kernel, for longer Sk, on the tensor cores: one block of
//   four warps per (sequence b, KV head, tile of query rows) of the
//   group's heads, packed head-major; each warp owns MT m-tiles of 16
//   rows. Both products run as mma.sync.m16n8k8 TF32 with f32
//   accumulation, split 3xTF32 to keep f32 accuracy: hi = rna_tf32(a),
//   lo = rna_tf32(a - hi), a b ~ lo hi + hi lo + hi hi, small terms first
//   (lo lo, about 2^-22 relative, dropped). One TF32 product keeps about
//   3 digits and would miss the 2e-5 tolerance, so P v is split as q k^T
//   is. The rounding is cvt.rna.tf32.f32's, written as two integer adds
//   and a mask (split_tf32): nvcc's cvt adds a compare and a select per
//   value to keep infinities, and with every fragment split by every warp
//   those were a tenth of the kernel's time (tools/kernel_ab.py). The
//   softmax stays in registers: a row's 8-key n-tiles sit in the
//   accumulators of the quad of threads that holds the row, so the
//   running max is two xor shuffles a tile, each thread keeps the sum of
//   its own columns (added across the quad once, at the end), and there
//   is no score tile in shared memory and no barrier between the
//   products. P's accumulator layout (thread tq holds keys 2 tq and
//   2 tq + 1 of rows gq and gq + 8) is the A fragment of P v once an
//   8-key step takes its keys in the order 0, 2, 4, 6, 1, 3, 5, 7; v's B
//   fragment reads its rows in that order, so no shuffle or staging
//   converts P. Q's rows (staged once) and two stages of K and V tiles
//   arrive by 16-byte cp.async (rows past the ends zero-filled): tile
//   i + 1's copy is issued right after the barrier that opens tile i and
//   lands while tile i computes -- one __syncthreads a tile. Rows in
//   shared memory are padded to hd + 4 floats: a fragment load has lanes
//   (8 rows x 4 columns) at row * 4 + column mod 32 banks, or for v's
//   reordered rows (4 rows two apart x 8 columns) at 8 tq + gq (+ 4):
//   every lane on its own bank. A split K or V fragment serves all MT
//   m-tiles of the warp. Per head width (shared memory (rows + 4 keys) x
//   (hd + 4) floats; blocks an SM by the register bound):
//     hd  64: MT 2 (128 rows a block), 32-key tiles -- 68 KB, 3 blocks;
//     hd 128: MT 2 (128 rows), 16-key tiles -- 99 KB, 2 blocks;
//     hd 192: MT 1 (64 rows), 16-key tiles -- 98 KB, 2 blocks (two
//             m-tiles' accumulators, 192 registers, would not fit).
//   Larger key tiles, a third stage, and four m-tiles at hd 64 each ran
//   slower (fewer blocks an SM; tools/kernel_ab.py). Key tiles wholly
//   outside every row's causal / window reach are skipped, as before
//   (their weights are exact zeros in the reference too: exp(-1e30 - m) =
//   0, or erased by alpha = exp(-1e30 - m) = 0 when they came first); a
//   warp also skips the tiles and the 8-key n-tiles past the last key its
//   own rows reach, and masks per element only in tiles where one of its
//   rows masks a key. The tile index runs slowest and backwards over the
//   grid, so every group's heaviest causal tiles start first and light
//   ones fill the tail. The copies need 16-byte aligned q, k and v; the
//   wrapper passes a fresh copy of an operand that is not.
//
// Blocks go on gridDim.x (B * Hkv * ceil(g * S / rows) for both, rows
// 64 for the short kernel and as above for the tile kernel: 81,920 for
// the whole measurement stack in one launch, past the 65,535 of the y
// axis).
//
// What held the previous tile kernel back at long S (its first design, 28.7%
// of the f32 operation bound at smollm's train shape, slower than f32
// scaled_dot_product_attention at hd 192): scalar FMAs from padded shared
// memory, a 64 x 65 score tile written to shared memory, and four
// __syncthreads a key tile. At S = 15 it also staged mostly padding,
// which is why the short kernel exists.
//
// Precision: expf (not __expf), IEEE division, no --use_fast_math. The
// online softmax reassociates the reference's sums, and 3xTF32 rounds
// each product's terms, so both instances are held to 2e-5 against the
// plain version, not bit for bit.
//
// Bound: q, k and v read once and o written once; 4 B Hq S Sk_eff hd
// operations (two products, Sk_eff the keys in reach, about Sk / 2 under
// a causal mask). At the DFL path's S = 15 a (sequence, KV head) group
// does about 3 operations a byte, far below the f32 ridge of about 20,
// so bytes bound it; tensor cores would not help there, which is why the
// short kernel computes with scalar FMAs and spends its design on keeping
// loads in flight (many small blocks per SM, asynchronous copies, no
// padding). At S = 4,096 the operations bound it. Two bounds are stated:
// the f32-FMA bound, max(bytes / 3.35 TB/s, flops / 67 TFLOP/s), which
// earlier measurements used, and the tensor-core bound, max(bytes / 3.35
// TB/s, 3 flops / 495 TFLOP/s) -- three TF32 products for each f32 one,
// the least time for f32-accurate work by this route:
//   smollm-train (B 2, S 4,096, 15 / 5 heads of 64, causal, 64.4 GFLOP):
//     0.962 ms f32-FMA, 0.390 ms tensor-core;
//   hd 192 (B 1, S 1,000, 96 / 8 heads, causal, 36.9 GFLOP): 0.551 ms,
//     0.224 ms;
//   gemma3-local (B 1, S 4,096, 32 / 16 heads of 128, window 1,024,
//     60.1 GFLOP): 0.897 ms, 0.364 ms.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // four warps
constexpr float kNegInf = -1e30f;

// the tile kernel's shape per head width: each warp owns MT m-tiles of 16
// query rows (a block 64 MT rows), a key tile is KEYS keys; shared memory
// holds Q's rows and two stages of K and V, every row padded to hd + 4;
// MIN_BLOCKS blocks an SM bound the registers (65,536 / (128 MIN_BLOCKS))
template <int HD> struct TileShape;
template <> struct TileShape<64> {
  static constexpr int kMT = 2, kKeys = 32, kMinBlocks = 3;
};
template <> struct TileShape<128> {
  static constexpr int kMT = 2, kKeys = 16, kMinBlocks = 2;
};
template <> struct TileShape<192> {
  static constexpr int kMT = 1, kKeys = 16, kMinBlocks = 2;
};

template <int HD>
__host__ __device__ constexpr int tile_rows() {
  return 64 * TileShape<HD>::kMT;
}

template <int HD>
__host__ __device__ constexpr size_t tile_smem_floats() {
  return ((size_t)tile_rows<HD>() + 4 * TileShape<HD>::kKeys) * (HD + 4);
}

// 16 bytes, or 16 zero bytes where `fill` is false (nothing is read)
__device__ __forceinline__ void cp_async16_zfill(void* smem,
                                                 const void* gmem,
                                                 bool fill) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int src_bytes = fill ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// hi = cvt.rna.tf32(a), lo = cvt.rna.tf32(a - hi) for finite a, as
// integer operations: adding 0x1000 (half a TF32 ulp) to the bits rounds
// the magnitude to nearest, ties away, and the tensor cores read only the
// top 19 bits of a TF32 operand, so the sum's low bits need no clearing
// (hi's value is masked once, for the subtraction). nvcc's cvt.rna adds a
// compare and a select per value to keep infinities, which q, k, v and p
// do not hold here (scores out of reach are -1e30, not -inf).
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(a) + 0x1000u;
  const float rest = a - __uint_as_float(hi & 0xffffe000u);
  lo = __float_as_uint(rest) + 0x1000u;
}

// c += a b on the tensor cores: a 16 x 8 (row), b 8 x 8 (col), TF32 in,
// f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32, the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, TileShape<HD>::kMinBlocks)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int Sk, int Hq, int Hkv, int tiles, int causal, int window,
                 float scale) {
  constexpr int MT = TileShape<HD>::kMT;
  constexpr int KEYS = TileShape<HD>::kKeys;
  constexpr int ROWS = tile_rows<HD>();
  constexpr int LD = HD + 4;           // row stride of Q, K, V tiles
  constexpr int KS = HD / 8;           // k-steps of QK^T, n-tiles of PV
  constexpr int NJ = KEYS / 8;         // n-tiles of QK^T, k-steps of PV
  constexpr int C4 = HD / 4;           // 16-byte chunks a row
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // [ROWS][LD]
  float* stages = sq + ROWS * LD;               // [2][K, V][KEYS][LD]

  const int g = Hq / Hkv;
  const int rows_total = g * S;
  // the tile index varies slowest and runs backwards, so the blocks of
  // every (sequence, KV head) group's last tiles -- the heaviest under a
  // causal mask -- start first and the light ones fill the tail
  const int64_t groups = gridDim.x / tiles;
  const int tile = tiles - 1 - (int)(blockIdx.x / groups);
  const int64_t grp = blockIdx.x % groups;
  const int kvh = (int)(grp % Hkv);
  const int64_t b = grp / Hkv;
  const int r0 = tile * ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;

  // row r of the tile is (head kvh * g + r / S, position r % S); the
  // thread's rows in m-tile mt of its warp: w0 + 16 mt + gq (+ 8)
  auto q_off = [&](int row) -> int64_t {
    return ((b * S + row % S) * Hq + kvh * g + row / S) * (int64_t)HD;
  };
  const int w0 = r0 + warp * 16 * MT;
  int pos[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = w0 + 16 * mt + 8 * h + gq;
      pos[mt][h] = row < rows_total ? row % S : S - 1;
    }

  // the keys the block's rows reach, and those of this warp's rows
  auto reach = [&](int first, int last, int& lo, int& hi, int& pmin,
                   int& pmax) {
    pmin = 0;
    pmax = S - 1;
    if (first / S == last / S) {
      pmin = first % S;
      pmax = last % S;
    }
    hi = causal ? min(pmax, Sk - 1) : Sk - 1;
    lo = window ? max(0, pmin - window + 1) : 0;
  };
  int k_lo, k_hi, pmin, pmax;
  reach(r0, min(r0 + ROWS, rows_total) - 1, k_lo, k_hi, pmin, pmax);
  const bool live = w0 < rows_total;
  int w_lo = 0, w_hi = -1;
  if (live)
    reach(w0, min(w0 + 16 * MT, rows_total) - 1, w_lo, w_hi, pmin, pmax);

  // the block's query rows (0 past the last), staged with K/V tile 0
  for (int idx = tid; idx < ROWS * C4; idx += kThreads) {
    const int r = idx / C4, c = idx % C4, row = r0 + r;
    const bool in = row < rows_total;
    cp_async16_zfill(sq + r * LD + 4 * c, q + (in ? q_off(row) + 4 * c : 0),
                     in);
  }

  // a key tile's K and V rows into a stage, 16 bytes a copy; keys past
  // Sk are zero-filled
  auto stage_tile = [&](int kt, int st) {
    float* sk = stages + st * 2 * KEYS * LD;
    float* sv = sk + KEYS * LD;
    for (int idx = tid; idx < KEYS * C4; idx += kThreads) {
      const int j = idx / C4, c = idx % C4, key = kt * KEYS + j;
      const bool in = key < Sk;
      const int64_t off =
          in ? ((b * Sk + key) * Hkv + kvh) * (int64_t)HD + 4 * c : 0;
      cp_async16_zfill(sk + j * LD + 4 * c, k + off, in);
      cp_async16_zfill(sv + j * LD + 4 * c, v + off, in);
    }
    cp_async_commit();
  };

  float m[MT][2], l[MT][2], acc[MT][KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  }

  const int kt0 = k_lo / KEYS, kt1 = k_hi / KEYS;
  stage_tile(kt0, 0);
  for (int kt = kt0; kt <= kt1; ++kt) {
    const int st = (kt - kt0) & 1;
    // this tile (and Q) has landed, and every warp is done with the last
    // tile, whose stage the next copy overwrites
    cp_async_wait_all();
    __syncthreads();
    if (kt < kt1) stage_tile(kt + 1, st ^ 1);
    const int j0 = kt * KEYS;
    if (!live || j0 > w_hi || j0 + KEYS - 1 < w_lo) continue;
    const float* sk = stages + st * 2 * KEYS * LD;
    const float* sv = sk + KEYS * LD;
    // the n-tiles of keys this warp reaches (a causal diagonal stops
    // early), and whether any of its rows masks a key of the tile
    const int nj = min(NJ, (w_hi - j0) / 8 + 1);
    const bool masked = j0 + KEYS > Sk ||
                        (causal && j0 + KEYS - 1 > pmin) ||
                        (window && j0 <= pmax - window);

    // s = q k^T in 3xTF32; a split K fragment serves every m-tile
    float s[MT][NJ][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* qr = sq + (warp * 16 * MT + 16 * mt + gq) * LD +
                          8 * ks + tq;
        split_tf32(qr[0], ah[mt][0], al[mt][0]);
        split_tf32(qr[8 * LD], ah[mt][1], al[mt][1]);
        split_tf32(qr[4], ah[mt][2], al[mt][2]);
        split_tf32(qr[8 * LD + 4], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j < nj) {
          const float* kr = sk + (8 * j + gq) * LD + 8 * ks + tq;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(kr[0], bh0, bl0);
          split_tf32(kr[4], bh1, bl1);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_3xtf32(s[mt][j], ah[mt], al[mt], bh0, bh1, bl0, bl1);
        }
      }
    }

#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // scale, mask, and the rows' running max
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float val = s[mt][j][e] * scale;
          if (masked) {
            const int key = j0 + 8 * j + 2 * tq + (e & 1);
            const int p = pos[mt][e >> 1];
            const bool in_reach = key < Sk && (!causal || key <= p) &&
                                  (!window || key > p - window);
            if (!in_reach) val = kNegInf;
          }
          s[mt][j][e] = val;
        }
        if (j < nj) {
          mx[0] = fmaxf(mx[0], fmaxf(s[mt][j][0], s[mt][j][1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[mt][j][2], s[mt][j][3]));
        }
      }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float mn = fmaxf(m[mt][h], mx[h]);
        alpha[h] = expf(m[mt][h] - mn);
        m[mt][h] = mn;
      }
      // p = exp(s - m); each thread keeps the sum of its own columns (the
      // quad's partial sums are added once, at the end)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j < nj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[mt][j][e] = expf(s[mt][j][e] - m[mt][e >> 1]);
            sum[e >> 1] += s[mt][j][e];
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[mt][h] = l[mt][h] * alpha[h] + sum[h];
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        acc[mt][n][0] *= alpha[0];
        acc[mt][n][1] *= alpha[0];
        acc[mt][n][2] *= alpha[1];
        acc[mt][n][3] *= alpha[1];
      }
    }

    // acc += p v in 3xTF32. p's accumulator layout is the A fragment of
    // the next product once the keys of an 8-key step are taken in the
    // order 0, 2, 4, 6, 1, 3, 5, 7: thread tq holds keys 2 tq and 2 tq + 1
    // of rows gq and gq + 8, which are A's columns tq and tq + 4 -- so B
    // (v) reads its rows in the same order and no shuffle is needed; a
    // split V fragment serves every m-tile
#pragma unroll
    for (int kk = 0; kk < NJ; ++kk) {
      if (kk < nj) {
        uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          split_tf32(s[mt][kk][0], ph[mt][0], pl[mt][0]);
          split_tf32(s[mt][kk][2], ph[mt][1], pl[mt][1]);
          split_tf32(s[mt][kk][1], ph[mt][2], pl[mt][2]);
          split_tf32(s[mt][kk][3], ph[mt][3], pl[mt][3]);
        }
        const float* vr = sv + (8 * kk + 2 * tq) * LD + gq;
#pragma unroll
        for (int n = 0; n < KS; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(vr[8 * n], bh0, bl0);
          split_tf32(vr[LD + 8 * n], bh1, bl1);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_3xtf32(acc[mt][n], ph[mt], pl[mt], bh0, bh1, bl0, bl1);
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lh = l[mt][h];
      lh += __shfl_xor_sync(0xffffffffu, lh, 1);
      lh += __shfl_xor_sync(0xffffffffu, lh, 2);
      const float den = fmaxf(lh, 1e-30f);
      const int row = w0 + 16 * mt + 8 * h + gq;
      if (row >= rows_total) continue;
      float2* orow = reinterpret_cast<float2*>(o + q_off(row) + 2 * tq);
#pragma unroll
      for (int n = 0; n < KS; ++n)
        orow[4 * n] = make_float2(acc[mt][n][2 * h] / den,
                                  acc[mt][n][2 * h + 1] / den);
    }
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int S, int Sk, int Hq, int Hkv, int causal, int window,
           float scale, cudaStream_t stream) {
  const size_t smem = tile_smem_floats<HD>() * sizeof(float);
  static bool opted_in = false;        // once per instance and process
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const int rows = (Hq / Hkv) * S;
  const int tiles = (rows + tile_rows<HD>() - 1) / tile_rows<HD>();
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
// instance (`short_path`: Sk within its limit, at most 64, and q, k, v,
// o 16-byte aligned; the tile kernel also needs q, k, v aligned) and
// checks shapes, dtypes, devices, Hq % Hkv == 0, S <= Sk and
// B * Hkv * ceil(g * S / rows) < 2**31 (rows a block: 64 for the short
// kernel, tile_rows<hd>() for the tile kernel).
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
