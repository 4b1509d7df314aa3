// flash_attention's bf16 tile instance: grouped-query attention forward
// with an online softmax on bf16 operands, for Hopper's warpgroup tensor
// cores (sm_90a), causal and sliding-window masks.
//
//     o[b, s, h, :] = bf16(sum_t softmax_t(q[b, s, h, :] . k[b, t, h / g, :]
//                                          * hd^-0.5, masked)
//                          * v[b, t, h / g, :])
//
// q, o [B, S, Hq, hd] and k, v [B, Sk, Hkv, hd], contiguous bf16 (the
// registry models' layout, no transposes); g = Hq / Hkv query heads share a
// KV head. Key t is in reach of query s when t < Sk, t <= s (causal) and
// t > s - window (window > 0); out-of-reach scores are -1e30, as in the
// reference. The caller (flash_attention.cu's flash_attention_bf16, from
// repro_torch/kernels/ops.py) sends here every bf16 call that
// ops.flash_instance gives the tile kernel, with S <= Sk and q, k, v on
// 16 bytes.
//
// Replaces, for bf16 operands, the TPU kernel
// repro/kernels/flash_attention.py: flash_attention_fwd (:77, body
// _attn_kernel), and computes what it computes on them: q k^T of the exact
// bf16 values accumulated in f32, the scale, the -1e30 mask and the online
// softmax in f32, p v accumulated in f32, the output rounded to bf16 once
// (round to nearest even). The plain version (ref.flash_attention_ref)
// upcasts, runs the f32 composition and rounds once, so this instance
// agrees with it to one bf16 ulp per element.
//
// Design. One block per (sequence b, query head h, tile of 128 query
// positions): three warpgroups, warp-specialised.
// * Warpgroup 0 is the producer: it gives up registers (setmaxnreg 40) and
//   one thread issues the TMA copies (cp.async.bulk.tensor, 4-d tensor
//   maps over the unpadded [B, L, H, hd] layouts, built on the host at
//   each launch and passed as __grid_constant__ parameters): the block's
//   Q rows once, then each key tile's K and V rows into a ring of kStages
//   stages, each stage behind a "full" mbarrier (the copies' bytes) and an
//   "empty" one (every consumer warp done with it). A row is cut in chunks
//   of 64 columns, 128 bytes, each loaded with the 128-byte swizzle that
//   wgmma's descriptors read without bank conflicts; rows and columns past
//   the tensor's ends (ragged S and Sk, and hd 112's last 16 columns of its
//   second chunk) arrive as zeros.
// * Warpgroups 1 and 2 are the consumers (setmaxnreg 232; ptxas compiles
//   their code at the launch's 168 registers all the same, with spills of
//   24-104 bytes at hd 112-192), 64 query rows each, on the same K / V
//   stream. They take turns on the tensor cores (named barriers 1 and 2:
//   each issues a product only after the other has issued its last), so
//   one's softmax runs while the other's product does. Per key tile:
//   - s = q k^T as wgmma.mma_async m64nKEYSk16, f32 += bf16 x bf16, Q and K
//     both K-major from shared memory (hd / 16 k-steps);
//   - mask (only on a tile that crosses the diagonal, the window's edge
//     or Sk), the rows' running max of s (two xor shuffles over the quad
//     of threads that holds a row), p = exp(s scale - m scale) as 2^(s c
//     - m c) with c = scale log2(e) (one FFMA and MUFU.EX2 an element)
//     and the rows' sums, in f32 registers: wgmma's accumulator layout
//     puts a row's columns in one quad, as mma.sync's does;
//   - p v: p is split hi = bf16(p), lo = bf16(p - hi), both multiplied by
//     V (one bf16 p keeps 8 bits and loses the function: 10.8-11.5% of
//     the elements past one bf16 ulp at S = 512-1,024 in a model of this
//     arithmetic, none with the split,
//     tests/test_torch_flash_bf16_model.py). p's accumulator registers
//     are A fragments of the m64nNk16 product as they stand (thread
//     (gq, tq) holds keys 2 tq, 2 tq + 1 and 8 + 2 tq, 9 + 2 tq of rows
//     gq and gq + 8 of its warp's 16), so P goes from registers; V comes
//     from shared memory as an MN-major B (16-bit wgmma reads it
//     transposed), one m64n64k16 chain per 64-column chunk of hd;
//   - each tile's p v starts from zero (scale-d 0 on its first k-step) and
//     is added to the output accumulator on the CUDA cores, in the FFMA
//     that applies the online softmax's rescale: the tensor cores' f32
//     accumulation truncates, and chained into the output over every key
//     tile of a long row it drifted (the f32 and earlier bf16 tiles do the
//     same, tools/flash_serving_calls.py). Key tiles of 64-128 keys (in
//     place of 16-32) make that add and the rescale run 4-8x less often a
//     key.
// * Key tiles wholly outside every row's causal / window reach are not
//   loaded; a consumer warpgroup whose own rows do not reach a loaded tile
//   passes it. The tile index runs slowest and backwards over the grid, so
//   the heaviest causal tiles start first. The g query heads of a KV group
//   are neighbouring blocks of one tile index and read the same K / V rows
//   from L2.
//
// Per head width (kKeys keys a tile, kStages stages; shared memory Q 128
// rows + stages x 2 x kKeys rows, each row ceil(hd / 64) chunks of 128
// bytes; registers a consumer thread: the output accumulator hd / 2
// floats (padded to 64 columns), s / p kKeys / 2, one chunk's p v 32):
//   hd  64: 128 keys, 2 stages --  80 KB;
//   hd 112: 128 keys, 2 stages -- 160 KB (rows padded to 128 columns);
//   hd 128: 128 keys, 2 stages -- 160 KB;
//   hd 192:  64 keys, 2 stages -- 144 KB (a 128-key stage would not fit).
//
// Precision: ex2.approx (relative error about 2^-22, far inside the
// output's bf16 rounding: the one-ulp bound holds on every case of
// tests/test_torch_kernels.py and chip_smoke.py), IEEE division, no
// --use_fast_math.
//
// Bound: q, k and v read once and o written once at 2 bytes an element;
// 4 B Hq hd (pairs in reach) operations (two products). Two bounds are
// stated: max(bytes / 3.35 TB/s, flops / 989 TFLOP/s), bf16's dense rate,
// and the issued bound, with the operations this instance issues: 1.5
// times the flops (q k^T once, p v twice).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kConsumers = 2;                 // consumer warpgroups a block
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kRows = 64 * kConsumers;        // query rows a block
constexpr int kChunk = 64;                    // columns a 128-byte row chunk
constexpr uint32_t kRowBytes = 128;
constexpr float kNegInf = -1e30f;
// an mbarrier wait that has not completed after this many cycles traps (a
// fault that would otherwise hang the card)
constexpr long long kWaitLimit = 1ll << 34;
// registers a thread of the producer and of a consumer warpgroup
// (setmaxnreg; 128 of the one and 256 of the other within the SM's 65,536)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// key tile and ring depth per head width
constexpr int kKeys64 = 128;
constexpr int kStages64 = 2;
constexpr int kKeys112 = 128;
constexpr int kStages112 = 2;
constexpr int kKeys128 = 128;
constexpr int kStages128 = 2;
constexpr int kKeys192 = 64;
constexpr int kStages192 = 2;

template <int HD> struct Bf16Tile;
template <> struct Bf16Tile<64> {
  static constexpr int kKeys = kKeys64, kStages = kStages64;
};
template <> struct Bf16Tile<112> {
  static constexpr int kKeys = kKeys112, kStages = kStages112;
};
template <> struct Bf16Tile<128> {
  static constexpr int kKeys = kKeys128, kStages = kStages128;
};
template <> struct Bf16Tile<192> {
  static constexpr int kKeys = kKeys192, kStages = kStages192;
};

template <int HD>
__host__ __device__ constexpr int chunks() {
  return (HD + kChunk - 1) / kChunk;
}

template <int HD>
__host__ __device__ constexpr uint32_t stage_bytes() {
  return 2u * chunks<HD>() * Bf16Tile<HD>::kKeys * kRowBytes;
}

// dynamic shared memory: Q, the stages, 2 kStages + 1 mbarriers, and room
// to align the start to the 1,024 bytes of the 128-byte swizzle's pattern
template <int HD>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)chunks<HD>() * kRows * kRowBytes +
         (size_t)Bf16Tile<HD>::kStages * stage_bytes<HD>() +
         8 * (2 * Bf16Tile<HD>::kStages + 1) + 1024;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// --- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > kWaitLimit) __trap();
  }
}

// --- TMA ---------------------------------------------------------------------

// a box of the 4-d tensor map at coordinates (c0 innermost) into shared
// memory, its bytes reported to `bar`
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map,
                                          int c0, int c1, int c2, int c3,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// --- wgmma -------------------------------------------------------------------

// a shared-memory matrix descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1 (128B
// swizzle)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3ffff) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from touching an accumulator between a wgmma's issue
// and its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define D8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= a b, m64n64k16: a and b from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= a b, m64n128k16: a and b from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= a b, m64n64k16: a from registers, b from shared memory MN-major
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

#undef D8

template <int KEYS>
__device__ __forceinline__ void wgmma_qk(float (&d)[KEYS / 2], uint64_t da,
                                         uint64_t db, int accumulate);
template <>
__device__ __forceinline__ void wgmma_qk<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  wgmma_ss_n64(d, da, db, accumulate);
}
template <>
__device__ __forceinline__ void wgmma_qk<128>(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  wgmma_ss_n128(d, da, db, accumulate);
}

// 2^x, MUFU.EX2 (relative error about 2^-22; results below 2^-126 flush
// to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats as a bf16x2 register (x in the low half), rounded to nearest
// even, and the rest each leaves
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - __low2float(h),
                                                 y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  bf16* __restrict__ o, int S, int Sk, int Hq, int Hkv,
                  int tiles, int causal, int window, float scale) {
  constexpr int KEYS = Bf16Tile<HD>::kKeys;
  constexpr int ST = Bf16Tile<HD>::kStages;
  constexpr int NC = chunks<HD>();        // 64-column chunks of a row
  constexpr int KS = HD / 16;             // k-steps of q k^T
  constexpr int KP = KEYS / 16;           // k-steps of p v
  constexpr uint32_t Q_CHUNK = kRows * kRowBytes;
  constexpr uint32_t KV_CHUNK = KEYS * kRowBytes;
  constexpr uint32_t STAGE = stage_bytes<HD>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sst = sq + NC * Q_CHUNK;
  const uint32_t bars = sst + ST * STAGE;  // full[ST], empty[ST], q
  const uint32_t qbar = bars + 16 * ST;

  // the tile index varies slowest and runs backwards: every (sequence,
  // head)'s last tiles -- the heaviest under a causal mask -- start first
  const int64_t groups = gridDim.x / tiles;
  const int tile = tiles - 1 - (int)(blockIdx.x / groups);
  const int64_t grp = blockIdx.x % groups;
  const int h = (int)(grp % Hq);
  const int b = (int)(grp / Hq);
  const int kvh = h / (Hq / Hkv);
  const int s0 = tile * kRows;
  // the key tiles any row of the block reaches
  const int s_last = min(s0 + kRows, S) - 1;
  const int k_hi = causal ? min(s_last, Sk - 1) : Sk - 1;
  const int k_lo = window ? max(0, s0 - window + 1) : 0;
  const int kt0 = k_lo / KEYS, kt1 = k_hi / KEYS;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int st = 0; st < ST; ++st) {
      mbar_init(bars + 8 * st, 1);
      mbar_init(bars + 8 * (ST + st), 4 * kConsumers);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs)
                 : "memory");
    if (tid == 0) {
      mbar_expect_tx(qbar, NC * Q_CHUNK);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        tma_load4(sq + c * Q_CHUNK, &tq, kChunk * c, h, s0, b, qbar);
      for (int kt = kt0; kt <= kt1; ++kt) {
        const int it = kt - kt0, st = it % ST;
        mbar_wait(bars + 8 * (ST + st), ((it / ST) & 1) ^ 1);
        const uint32_t full = bars + 8 * st;
        mbar_expect_tx(full, STAGE);
        const uint32_t sk = sst + st * STAGE, sv = sk + NC * KV_CHUNK;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          tma_load4(sk + c * KV_CHUNK, &tk, kChunk * c, kvh, kt * KEYS, b,
                    full);
          tma_load4(sv + c * KV_CHUNK, &tv, kChunk * c, kvh, kt * KEYS, b,
                    full);
        }
      }
    }
  } else {
    // the consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs)
                 : "memory");
    const int cw = tid / 128 - 1;              // consumer warpgroup
    const int warp = (tid / 32) & 3, lane = tid & 31;
    const int gq = lane >> 2, tq = lane & 3;
    // this warpgroup's positions, and the keys they reach
    const int r_lo = s0 + 64 * cw;
    const int r_hi = min(r_lo + 63, S - 1);
    const bool live = r_lo < S;
    const int w_hi = causal ? min(r_hi, Sk - 1) : Sk - 1;
    const int w_lo = window ? max(0, r_lo - window + 1) : 0;
    // this thread's two rows
    const int pos[2] = {r_lo + 16 * warp + gq, r_lo + 16 * warp + gq + 8};
    // exp(x scale) = 2^(x c)
    const float c = scale * 1.4426950408889634f;

    // the two warpgroups take turns on the tensor cores (named barriers 1
    // and 2): each issues a product only after the other has issued its
    // last, so one's softmax runs beside the other's product. A tile is
    // 1 + NC turns of every warpgroup, whether it computes or passes
    int turns_left = (kt1 - kt0 + 1) * (1 + NC);
    auto turn_wait = [&] {
      asm volatile("bar.sync %0, 256;\n" ::"r"(1 + cw) : "memory");
    };
    auto turn_pass = [&] {
      // warpgroup 1's first pass is made up front, so it skips its last
      if (--turns_left > 0 || cw == 0)
        asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - cw) : "memory");
    };
    if (cw == 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");

    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float acc[NC][32];
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[n][e] = 0.f;

    mbar_wait(qbar, 0);
    const uint32_t sq_wg = sq + cw * 64 * kRowBytes;
    for (int kt = kt0; kt <= kt1; ++kt) {
      const int it = kt - kt0, st = it % ST;
      mbar_wait(bars + 8 * st, (it / ST) & 1);
      const int j0 = kt * KEYS;
      if (live && j0 <= w_hi && j0 + KEYS - 1 >= w_lo) {
        const uint32_t sk = sst + st * STAGE, sv = sk + NC * KV_CHUNK;
        const bool masked = j0 + KEYS > Sk ||
                            (causal && j0 + KEYS - 1 > r_lo) ||
                            (window && j0 <= r_hi - window);

        // s = q k^T: k-step ks reads 16 columns, 32 bytes into its chunk's
        // swizzled rows (8-row groups 1,024 bytes apart)
        float s[KEYS / 2];
        turn_wait();
        fence_regs(s);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const uint32_t off = (ks % 4) * 32u;
          const uint64_t da =
              smem_desc(sq_wg + (ks / 4) * Q_CHUNK + off, 16, 1024);
          const uint64_t db =
              smem_desc(sk + (ks / 4) * KV_CHUNK + off, 16, 1024);
          wgmma_qk<KEYS>(s, da, db, ks > 0);
        }
        wgmma_commit();
        turn_pass();
        wgmma_wait_all();
        fence_regs(s);

        // mask and the rows' running max, in q k^T's units (scale > 0);
        // s[4 j + e] is key j0 + 8 j + 2 tq + (e & 1) of row pos[e >> 1]
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int j = 0; j < KEYS / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (masked) {
              const int key = j0 + 8 * j + 2 * tq + (e & 1);
              const int p = pos[e >> 1];
              const bool in_reach = key < Sk && (!causal || key <= p) &&
                                    (!window || key > p - window);
              if (!in_reach) s[4 * j + e] = kNegInf;
            }
            mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
          }
        }
        float alpha[2], mc[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float mn = fmaxf(m[r], mx[r]);
          alpha[r] = exp2_approx((m[r] - mn) * c);
          m[r] = mn;
          // a row that has reached no key yet (every score so far -1e30)
          // weighs its masked keys 0, not 1: s c - mc in one FFMA keeps
          // mn c's rounding error, 2^-24 of 1.8e29, and 2 to its power
          // is infinite. The reference weighs them 1 until a key in
          // reach erases them (alpha = 0), so both give that row's
          // first key in reach its whole weight
          mc[r] = mn == kNegInf ? 0.f : mn * c;
        }
        // p = exp(s scale - m scale), split into bf16 hi and lo A
        // fragments: k-step kk takes s[8 kk .. 8 kk + 7] in register order
        uint32_t ph[KP][4], pl[KP][4];
#pragma unroll
        for (int kk = 0; kk < KP; ++kk) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = i & 1;
            const float x = exp2_approx(fmaf(s[8 * kk + 2 * i], c, -mc[r]));
            const float y =
                exp2_approx(fmaf(s[8 * kk + 2 * i + 1], c, -mc[r]));
            sum[r] += x + y;
            split_bf16x2(x, y, ph[kk][i], pl[kk][i]);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];

        // acc = alpha acc + p v, a 64-column chunk (a turn) at a time; the
        // tile's product starts from zero (scale-d 0) and is added on the
        // CUDA cores. p v's k-step kk reads 16 keys, two 8-key groups 1,024
        // bytes apart, of the chunk's MN-major swizzled V rows
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          float part[32];
          turn_wait();
          fence_regs(part);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KP; ++kk) {
            const uint64_t db =
                smem_desc(sv + n * KV_CHUNK + kk * 2048u, KV_CHUNK, 1024);
            wgmma_rs_n64(part, pl[kk], db, kk > 0);
            wgmma_rs_n64(part, ph[kk], db, 1);
          }
          wgmma_commit();
          turn_pass();
          wgmma_wait_all();
          fence_regs(part);
#pragma unroll
          for (int e = 0; e < 32; ++e)
            acc[n][e] = fmaf(acc[n][e], alpha[(e >> 1) & 1], part[e]);
        }
      } else {
        for (int t = 0; t < 1 + NC; ++t) {
          turn_wait();
          turn_pass();
        }
      }
      // this warp is done with the stage
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (ST + st));
    }

    if (live) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float lr = l[r];
        lr += __shfl_xor_sync(0xffffffffu, lr, 1);
        lr += __shfl_xor_sync(0xffffffffu, lr, 2);
        const float den = fmaxf(lr, 1e-30f);
        if (pos[r] >= S) continue;
        bf16* orow =
            o + (((int64_t)b * S + pos[r]) * Hq + h) * HD + 2 * tq;
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = kChunk * n + 8 * j;
            if (col < HD)
              *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                  __floats2bfloat162_rn(acc[n][4 * j + 2 * r] / den,
                                        acc[n][4 * j + 2 * r + 1] / den);
          }
      }
    }
  }
}

// --- host --------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a tensor map over bf16 [B, L, H, hd] (dims innermost first: hd, H, L,
// B) with boxes of 64 columns x `rows` positions of one head, 128-byte
// swizzle, zeros past the ends
bool tensor_map(CUtensorMap* map, const void* base, int B, int L, int H,
                int hd, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)H * hd * 2,
                                 (cuuint64_t)L * H * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kChunk, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int Sk, int Hq, int Hkv, int causal, int window,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  static bool opted_in = false;        // once per instance and process
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  CUtensorMap mq, mk, mv;
  if (!tensor_map(&mq, q, B, S, Hq, HD, kRows) ||
      !tensor_map(&mk, k, B, Sk, Hkv, HD, Bf16Tile<HD>::kKeys) ||
      !tensor_map(&mv, v, B, Sk, Hkv, HD, Bf16Tile<HD>::kKeys))
    return (int)cudaErrorInvalidValue;
  const int tiles = (S + kRows - 1) / kRows;
  const unsigned grid = (unsigned)((int64_t)B * Hq * tiles);
  flash_bf16_kernel<HD><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), S, Sk, Hq, Hkv, tiles, causal,
      window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The bf16 tile instance: launches on `stream`, allocates nothing, and
// returns a cudaError_t as an int (0 == success; cudaErrorInvalidValue for
// a head dim without an instance or a tensor map the driver refuses). The
// caller checks shapes, dtypes, devices, 16-byte aligned q, k, v, Hq % Hkv
// == 0, S <= Sk and B * Hq * ceil(S / 128) < 2**31.
extern "C" int flash_attention_bf16_tile(const void* q, const void* k,
                                         const void* v, void* o, int B,
                                         int S, int Sk, int Hq, int Hkv,
                                         int hd, int causal, int window,
                                         float scale, void* stream) {
  if (B == 0 || S == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 64:
      return launch<64>(q, k, v, o, B, S, Sk, Hq, Hkv, causal, window, scale,
                        st);
    case 112:
      return launch<112>(q, k, v, o, B, S, Sk, Hq, Hkv, causal, window,
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
