// Flash-attention backward, dQ (and dS) and dK/dV, for float16 inputs at
// head dim 256 on Hopper tensor cores (sm_90a): native float16 wgmma fed by
// TMA, CUDA C++ with plain C entries.
//
// Replaces: paddle_tpu/kernels/flash_attention.py `_bwd_dq_kernel` (:198,
// pallas_call at :466) and `_bwd_dkv_kernel` (:269, pallas_call at :513),
// both launched by `_flash_bwd_impl` (:411), with their in-kernel dropout
// (`_dropout_mask`, :120; here philox.cuh), for float16 q/k/v/dO at head
// dim 256: the attention backward of a float16 (O2) model with 256-wide
// heads. D 64/128 take flash_attention_bwd_f16_sm90.cu, the float16
// forward flash_attention_fwd_f16_sm90.cu; the Python wrapper routes by
// (dtype, D, kernel). The float16 instantiation of
// flash_attention_bwd_f32_d256_sm90.cu (a split pre-pass and six term pairs
// a product) is on no route: the yardstick these kernels are timed against.
//
// Computes what the other backward kernels compute (flash_bwd_sm90.cuh):
// dQ and, when asked for, dS as float32 [B, H, Lq, Lk] with zeros on the
// tiles the causal mask skips; dK and dV; the three gradients rounded once
// to float16, from float32, as they are written through their strides.
//
// Numerics: those of flash_attention_bwd_f16_sm90.cu (its design note).
// S = Q K^T and dP = dO V^T (S^T and dP^T in dK/dV) are one native
// wgmma ...f32.f16.f16 each: a product of two float16 values is exact in
// float32. dS K and dS^T Q take dS as three bf16 terms (it keeps float32's
// range: under a loss scale dP may pass float16's 65504) against the
// float16 operand's two bf16 terms, which are exact; of the six term pairs
// the five with a + j <= 2 are kept, small pairs first (sm90.cuh, "Order").
// (P M)^T dO takes P M s as a float16 hi/lo pair (s a power of two), and dV
// is multiplied by 1 / s as it is stored.
//
// Design, from the bf16 D = 256 kernels (flash_attention_bwd_{dq,dkv}_
// sm90.cu), whose accumulators already fit by splitting the 256 columns
// between two consumer warpgroups; what float16 adds is the float16
// operand's second bf16 term, one more [64, 256] tile (32 KB), made in
// shared memory from the TMA tile (both types are 2 bytes and the 128-byte
// swizzle moves bytes, so an element keeps its byte offset):
// - dQ: one CTA per (b, h, 64 query rows), the query tile the slowest grid
//   dimension, walked from the last; two consumer warpgroups and a producer
//   warp (288 threads, 168 registers a thread). The producer loads Q and dO
//   once and streams K and V tiles of 64 keys through 2-stage rings. Per key
//   tile each warpgroup makes S and dP for 32 of the 64 keys (m64n32k16
//   over all 256 columns) and dS there. After a named barrier of both
//   warpgroups (both have read K and V, and both have finished the last
//   tile's dS K), they store dS's three bf16 terms into shared [64, 64]
//   tiles in the A-operand layout, and together turn K's stage into K's
//   first term in place and V's stage, which dP has read, into K's second;
//   a proxy fence and the barrier again; then each adds dS K[:, its 128
//   columns] into its half of dQ with the five pairs (m64n128k16, both
//   operands in shared memory), and both stages are released. Q, dO, the
//   rings and dS take 216 KB, as in the bf16 kernel: one CTA per SM.
// - dK/dV: one CTA per (b, h, 64 keys), 384 threads: two consumer
//   warpgroups that own the same 64 keys and a 128-column half of dK and dV
//   each (each makes S^T and dP^T whole, as the bf16 kernel does), and a
//   producer warpgroup. Warp 8 loads K and V once and streams Q by TMA
//   through a 2-stage ring, with each query tile's LSE and Delta, and dO;
//   warps 9-11 make Q's bf16 terms once both warpgroups' S^T have read the
//   stage's Q (an mbarrier of 256 arrivals): the first in place, the second
//   into one tile of its own, which that wait also frees (each warpgroup's
//   S^T of a tile comes after its dK of the one before). The consumers wait
//   for the terms only before dK, having run P^T, dV and dP^T meanwhile.
//   That tile is the 32 KB the bf16 kernel's second dO stage takes: dO has
//   one buffer, which only dV and dP^T read, so the next tile's dO loads
//   while dS^T, dK, S^T and P^T run. P^T waits in a 32 KB stash while dP^T
//   is made, as in the bf16 kernel, so that one score tile is live beside
//   dK and dV in the 232 registers a thread the consumers take from the
//   producer warpgroup (setmaxnreg 40 / 232; see consumer_wait). K, V, the
//   Q ring, dO, Q's second term, the stash and the statistics take 225 KB.
// - masks only on the diagonal and ragged tiles; dropout only in its own
//   instantiation, drawing the per-element Philox bits every kernel draws;
//   rows and keys past L arrive as zeros from TMA, keys past Lk get P = 0
//   and rows past Lq dS = 0; no atomics, so a run replays bit for bit.
//
// Bound on an H100 at [1, 8, 1024, 256] causal (4.20 M kept pairs): the
// least work, one float16 product a pair each (6 D and 8 D FLOP), is 0.0065
// (dQ) and 0.0087 ms (dK/dV) at 989 TFLOP/s. This design runs 7 products a
// pair in dQ (S, dP, five for dS K; 0.0152 ms) and 11 in dK/dV (S^T and
// dP^T in both warpgroups, two for dV, five for dK; 0.0239 ms). At 128
// CTAs on 132 SMs the longest causal CTA sets the time: 16 tiles of 64 x 64
// x 256 products, dQ 0.031 ms and dK/dV 0.049 ms at one SM's share of the
// peak.
//
// The kernels allocate nothing and do not synchronise.

#include "philox.cuh"
#include "sm90.cuh"
#include "flash_bwd_sm90.cuh"

namespace {

using namespace pt_bwd_sm90;
using Params = BwdParams<__half>;

constexpr int D = 256;
constexpr int kStages = 2;
constexpr int kGroups = 2;                      // consumer warpgroups
constexpr int kN = D / kGroups;                 // columns a warpgroup owns
constexpr int kGroupThreads = kConsumers * kGroups;  // warps 0-7
constexpr uint32_t kTile = 64 * D * 2;          // bytes of a [64, 256] tile

// ------------------------------------------------------------ dQ
constexpr int kDqThreads = kGroupThreads + 32;  // + a producer warp
constexpr int kDqBarrier = 1;  // named barrier of the 256 consumer threads
constexpr int kDqKeys = 64 / kGroups;  // keys a warpgroup makes S and dP for

struct DqLayout {
  static constexpr uint32_t q = 0, dout = kTile;
  __host__ __device__ static constexpr uint32_t k(int s) {
    return kTile * (2 + s);
  }
  __host__ __device__ static constexpr uint32_t v(int s) {
    return kTile * (2 + kStages + s);
  }
  // dS's three bf16 terms, one [64, 64] tile (one swizzle atom) each, as
  // the A operand of dS K
  static constexpr uint32_t ds = kTile * (2 + 2 * kStages);
  static constexpr uint32_t bars = ds + kSplit * kAtomBytes;
  static constexpr uint32_t qd_full = bars;
  __host__ __device__ static constexpr uint32_t k_full(int s) {
    return bars + 8 * (1 + s);
  }
  __host__ __device__ static constexpr uint32_t v_full(int s) {
    return bars + 8 * (1 + kStages + s);
  }
  __host__ __device__ static constexpr uint32_t k_empty(int s) {
    return bars + 8 * (1 + 2 * kStages + s);
  }
  __host__ __device__ static constexpr uint32_t v_empty(int s) {
    return bars + 8 * (1 + 3 * kStages + s);
  }
  // + 1024: the base is aligned up to the swizzle atom
  static constexpr size_t kBytes = bars + 8 * (1 + 4 * kStages) + 1024;
};

// The dropout keep bits of a dQ consumer thread's 16 elements of the keys
// k0 .. k0 + 31 (DqRows's element order). The seed is made opaque first, so
// that Philox's key schedule (20 words) is derived here and not hoisted out
// of the key-tile loop, where it spilled beside dQ at 168 registers (4
// bytes; drawn two elements at a time instead of all 16 it ran 3 % slower).
__device__ __forceinline__ uint32_t dq_keep_bits(const Params& p,
                                                 const DqRows& rows, int b,
                                                 int h, int k0) {
  DropoutParams d = p.drop;
  uint32_t lo = static_cast<uint32_t>(d.seed);
  uint32_t hi = static_cast<uint32_t>(d.seed >> 32);
  asm volatile("" : "+r"(lo), "+r"(hi));
  d.seed = (static_cast<unsigned long long>(hi) << 32) | lo;
  uint32_t keep = 0xffffffffu;
#pragma unroll
  for (int e = 0; e < kDqKeys / 2; ++e) {
    const int qi = (e & 3) < 2 ? rows.qi0 : rows.qi1;
    const int kj = k0 + 8 * (e >> 2) + 2 * rows.t + (e & 1);
    if (qi < p.Lq && kj < p.Lk && dropout_multiplier(d, b, h, qi, kj) == 0.f)
      keep &= ~(1u << e);
  }
  return keep;
}

// kDropout: the dropout draws are compiled only into the instantiation that
// uses them.
template <bool kDropout>
__global__ void __launch_bounds__(kDqThreads, 1)
flash_bwd_dq_f16_d256_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const __grid_constant__ CUtensorMap map_do,
                             const Params p) {
  using L = DqLayout;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - smem_u32(smem_raw));

  // The query tile is the slowest grid dimension, walked from the last:
  // the heaviest causal tiles of every (b, h) start first.
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * 64;
  // causal: keys past the tile's last query row are masked for every row
  const int n_kt = ((p.causal ? min(p.Lk, q0 + 64) : p.Lk) + 63) / 64;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(base + L::qd_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(base + L::k_full(s), 1);
      mbar_init(base + L::v_full(s), 1);
      mbar_init(base + L::k_empty(s), kGroupThreads);
      mbar_init(base + L::v_empty(s), kGroupThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kGroupThreads) {
    // ---- producer: one lane issues every copy
    if (tid != kGroupThreads) return;
    mbar_arrive_expect_tx(base + L::qd_full, 2 * kTile);
    tma_load_tile<D>(base + L::q, &map_q, base + L::qd_full, q0, h, b,
                     p.pos_q);
    tma_load_tile<D>(base + L::dout, &map_do, base + L::qd_full, q0, h, b,
                     p.pos_do);
    for (int i = 0; i < n_kt; ++i) {
      const int s = i % kStages;
      const uint32_t free_phase = ((i / kStages) & 1) ^ 1;
      mbar_wait(base + L::k_empty(s), free_phase);
      mbar_arrive_expect_tx(base + L::k_full(s), kTile);
      tma_load_tile<D>(base + L::k(s), &map_k, base + L::k_full(s), i * 64, h,
                       b, p.pos_k);
      mbar_wait(base + L::v_empty(s), free_phase);
      mbar_arrive_expect_tx(base + L::v_full(s), kTile);
      tma_load_tile<D>(base + L::v(s), &map_v, base + L::v_full(s), i * 64, h,
                       b, p.pos_v);
    }
    return;
  }

  // ---- consumer warpgroup wg: S and dP of keys kh .. kh + 31 of each key
  // tile, dQ columns col0 .. col0 + 127 of the 64 query rows
  const int wg = tid / kConsumers;
  const int kh = kDqKeys * wg, col0 = kN * wg;
  const DqRows rows(p, b, h, q0, tid % kConsumers);
  const float kept = kDropout ? p.drop.scale : 1.f;
  // where this thread's dS pairs go in a [64, 64] term tile: row r of the
  // 128-byte-swizzled atom at 128 r, its 16-byte chunk c at (c ^ r % 8) * 16
  // (rows 16 w + g and + 8 share r % 8 = g; chunk 4 wg + j holds keys
  // kh + 8 j .. kh + 8 j + 7, the thread's pair at byte 4 t of it)
  const int w = (tid % kConsumers) / 32, g = (tid % 32) / 4;
  uint32_t* const ds_row0 = reinterpret_cast<uint32_t*>(
      smem + L::ds + (16 * w + g) * 128 + 4 * rows.t);
  uint32_t* const ds_row1 = ds_row0 + 8 * 128 / 4;

  float dq[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) dq[i] = 0.f;

  mbar_wait(base + L::qd_full, 0);
  for (int i = 0; i < n_kt; ++i) {
    const int s = i % kStages;
    const uint32_t phase = (i / kStages) & 1;
    const int k0 = i * 64 + kh;  // the warpgroup's first key
    // the dropout keep bits of this thread's 16 elements, drawn before the
    // tile is waited for
    uint32_t keep = 0xffffffffu;
    if constexpr (kDropout) keep = dq_keep_bits(p, rows, b, h, k0);
    // the tiles' addresses, opaque to the compiler once per key tile, so
    // that each wgmma descriptor is built where it is used and not held
    // across the loop
    uint32_t tq = base + L::q, tdo = base + L::dout, tk = base + L::k(s),
             tv = base + L::v(s);
    asm volatile("" : "+r"(tq), "+r"(tdo), "+r"(tk), "+r"(tv));

    // ---- S = Q K[kh ..]^T, then P (the K rows kh .. start kh / 8 row
    // groups, 1024 bytes each, into every atom)
    mbar_wait(base + L::k_full(s), phase);
    __syncwarp();
    float sc[kDqKeys / 2], dp[kDqKeys / 2];
    wgmma_kmajor_product<D, __half>(sc, tq, tk + kh * 128);
    rows.probabilities(p, sc, q0, k0);

    // ---- dP = dO V[kh ..]^T, then dS = P (dP M - Delta) in its place
    mbar_wait(base + L::v_full(s), phase);
    __syncwarp();
    wgmma_kmajor_product<D, __half>(dp, tdo, tv + kh * 128);
    rows.grad_scores(sc, dp, keep, kept);
    if (rows.dsb != nullptr) rows.store_ds(dp, k0, p.Lq, p.Lk);

    // ---- once both warpgroups' S and dP have read K and V, and their
    // dS K of the last key tile has read the dS tiles and K's terms: dS's
    // three bf16 terms into the shared tiles, K's first bf16 term in place
    // of K and its second in V's stage
    named_barrier_sync(kDqBarrier, kGroupThreads);
#pragma unroll
    for (int j = 0; j < kDqKeys / 8; ++j) {
      const int chunk = ((4 * wg + j) ^ g) * 4;  // in words
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x0 = dp[4 * j + 2 * r], x1 = dp[4 * j + 2 * r + 1];
        uint32_t* const dst = (r == 0 ? ds_row0 : ds_row1) + chunk;
#pragma unroll
        for (int term = 0; term < kSplit; ++term) {
          const __nv_bfloat162 hb = __floats2bfloat162_rn(x0, x1);
          const float2 hf = __bfloat1622float2(hb);
          dst[term * kAtomBytes / 4] = bf16x2_bits(hb);
          x0 -= hf.x;
          x1 -= hf.y;
        }
      }
    }
    split_f16_tile<D, kGroupThreads>(smem + L::k(s), smem + L::v(s), tid);
    fence_proxy_async_smem();
    named_barrier_sync(kDqBarrier, kGroupThreads);

    // ---- dQ[:, col0 ..] += dS K[:, col0 ..]: dS's three bf16 terms
    // against K's two, the K columns 2 wg atoms in
    const uint32_t cols = (col0 / 64) * kAtomBytes;
    fence_operand(dq);
    wgmma_fence();
#pragma unroll
    for (int pr = 0; pr < kPairs; ++pr) {
      const uint32_t ta = base + L::ds + pair_a(pr) * kAtomBytes;
      const uint32_t tb = (pair_j(pr) == 0 ? tk : tv) + cols;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n128_tb(dq, kmajor_desc(ta, kk), mnmajor_desc(tb, kk), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operand(dq);
    mbar_arrive(base + L::k_empty(s));
    mbar_arrive(base + L::v_empty(s));
  }

  if (rows.dsb != nullptr && p.causal && n_kt * 64 < p.Lk)
    rows.zero_unseen_ds(q0, n_kt, p.Lq, p.Lk, tid, kGroupThreads);
  // ---- dQ[:, col0 ..] * scale, float16, through its strides
  store_rows<kN>(p.out0 + b * p.out0_st[0] + h * p.out0_st[1] + col0,
                 p.out0_st[2], rows.qi0, rows.qi1, p.Lq, rows.t, dq, p.scale);
}

// ------------------------------------------------------------ dK/dV
constexpr int kSplitters = 96;                       // warps 9-11
constexpr int kDkvThreads = kGroupThreads + 128;     // + a producer warpgroup
// Registers a thread: the CTA launches with 168 (65536 / 384); the producer
// warpgroup gives 128 of them back and the consumers take them
// (setmaxnreg), which the compiler counts on where it allocates the
// consumers' registers: dK and dV (128 floats), P^T and dP^T (64).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert((168 - kProducerRegs) * 128 >=
                  (kConsumerRegs - 168) * kGroupThreads,
              "the producer must free what the consumers take");

struct DkvLayout {
  // K and V of the CTA's 64 keys
  static constexpr uint32_t k = 0, v = kTile;
  // the ring of Q: Q of stage s (in place, once both S^T have read it: its
  // first bf16 term)
  __host__ __device__ static constexpr uint32_t q(int s) {
    return kTile * (2 + s);
  }
  // dO of the current query tile (one buffer: dV and dP^T read it, and the
  // next tile's loads while dS^T, dK, S^T and P^T run)
  static constexpr uint32_t dout = kTile * (2 + kStages);
  // Q's second bf16 term, of the query tile whose dK is next
  static constexpr uint32_t q_lo = dout + kTile;
  // each consumer thread's 32 values of P^T, parked while dP^T is made
  // (word e of thread tid at e * kGroupThreads + tid)
  static constexpr uint32_t stash = q_lo + kTile;
  // per stage: 64 floats of LSE, then 64 of Delta
  __host__ __device__ static constexpr uint32_t stats(int s) {
    return stash + 4 * 32 * kGroupThreads + 512 * s;
  }
  static constexpr uint32_t bars =
      stash + 4 * 32 * kGroupThreads + 512 * kStages;
  static constexpr uint32_t kv_full = bars;
  // Q and the statistics of stage s have landed; the stage is free
  __host__ __device__ static constexpr uint32_t full(int s) {
    return bars + 8 * (1 + s);
  }
  __host__ __device__ static constexpr uint32_t empty(int s) {
    return bars + 8 * (1 + kStages + s);
  }
  // both warpgroups' S^T have read the stage's float16 Q (and their dK of
  // the tile before has read Q's terms)
  __host__ __device__ static constexpr uint32_t read(int s) {
    return bars + 8 * (1 + 2 * kStages + s);
  }
  // the stage's Q terms are made
  __host__ __device__ static constexpr uint32_t terms(int s) {
    return bars + 8 * (1 + 3 * kStages + s);
  }
  // dO has landed; both warpgroups' dV and dP^T have read it
  static constexpr uint32_t do_full = bars + 8 * (1 + 4 * kStages);
  static constexpr uint32_t do_empty = do_full + 8;
  // set by a consumer wait that gave up (consumer_wait)
  static constexpr uint32_t fault = do_empty + 8;
  static constexpr size_t kBytes = fault + 8 + 1024;
};
static_assert(DkvLayout::kBytes <= 232448, "the dK/dV CTA's shared memory");

// The dK/dV consumers' wait: sm90.cuh's mbar_wait without its trap. Each
// trap site in the consumers' code kept ptxas from allocating the 232
// registers setmaxnreg gives them (with their four waits trapping, dK and
// dV spilled 780 bytes at 168 registers and ran 2.1 times slower; without
// the traps they use up to R219 and spill nothing). So after the same 2^21
// polls this wait gives up without a trap, and makes the fault visible
// all the same: it sets the CTA's fault word (DkvLayout::fault), and a
// thread that finds it set writes NaN for every element of dK and dV, so
// the float16 step's finiteness guard and FLAGS_check_nan_inf see the
// fault rather than plausible wrong gradients; the producer warps' waits
// trap as before. (Setting the accumulators to NaN at the give-up
// instead spilled 4 KB and ran 1.9 times slower.)
__device__ __forceinline__ void consumer_wait(uint32_t bar, uint32_t parity,
                                              uint32_t fault) {
  for (uint32_t polls = 0; polls <= (1u << 21); ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
  }
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(fault), "r"(1u) : "memory");
}

template <bool kDropout>
__global__ void __launch_bounds__(kDkvThreads, 1)
flash_bwd_dkv_f16_d256_kernel(const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v,
                              const __grid_constant__ CUtensorMap map_do,
                              const Params p) {
  using L = DkvLayout;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - smem_u32(smem_raw));
  const float* stats_ptr = reinterpret_cast<const float*>(smem);

  // The key tile is the slowest grid dimension, so the early (heaviest
  // causal) tiles of every (b, h) start first.
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * 64;
  // causal (top-left): query tile qt holds a kept pair of these keys iff its
  // last row reaches k0; the first, the diagonal tile, always does
  const int n_qt = (p.Lq + 63) / 64;
  const int qt0 = p.causal ? k0 / 64 : 0;
  const int n_iter = max(0, n_qt - qt0);
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(base + L::kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(base + L::full(s), 1 + 32);
      mbar_init(base + L::empty(s), kGroupThreads);
      mbar_init(base + L::read(s), kGroupThreads);
      mbar_init(base + L::terms(s), kSplitters);
    }
    mbar_init(base + L::do_full, 1);
    mbar_init(base + L::do_empty, kGroupThreads);
    *reinterpret_cast<volatile uint32_t*>(smem + L::fault) = 0u;
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kGroupThreads) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int lane = tid - kGroupThreads;
    if (lane >= 32) {
      // ---- warps 9-11: each stage's Q as its two bf16 terms, once the
      // tile has landed and both warpgroups' S^T have read it
      for (int i = 0; i < n_iter; ++i) {
        const int s = i % kStages;
        const uint32_t phase = (i / kStages) & 1;
        mbar_wait(base + L::full(s), phase);
        mbar_wait(base + L::read(s), phase);
        split_f16_tile<D, kSplitters>(smem + L::q(s), smem + L::q_lo,
                                      lane - 32);
        fence_proxy_async_smem();
        mbar_arrive(base + L::terms(s));
      }
      return;
    }
    // ---- warp 8: lane 0 issues the TMA copies, all 32 lanes copy the
    // tile's LSE and Delta rows. Q runs one tile ahead through its ring;
    // dO(i) loads once both warpgroups' dP^T have read dO(i - 1).
    const long long row_base = ((long long)b * p.H + h) * p.Lq;
    if (lane == 0) {
      mbar_arrive_expect_tx(base + L::kv_full, 2 * kTile);
      tma_load_tile<D>(base + L::k, &map_k, base + L::kv_full, k0, h, b,
                       p.pos_k);
      tma_load_tile<D>(base + L::v, &map_v, base + L::kv_full, k0, h, b,
                       p.pos_v);
    }
    for (int i = 0; i < n_iter; ++i) {
      const int s = i % kStages;
      const int q0 = (qt0 + i) * 64;
      mbar_wait(base + L::empty(s), ((i / kStages) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(base + L::full(s), kTile);
        tma_load_tile<D>(base + L::q(s), &map_q, base + L::full(s), q0, h, b,
                         p.pos_q);
      }
      float* st = const_cast<float*>(stats_ptr) + (L::stats(s) / 4);
#pragma unroll
      for (int r = lane; r < 64; r += 32) {
        const int qi = q0 + r;
        st[r] = qi < p.Lq ? p.lse[row_base + qi] : 0.f;
        st[64 + r] = qi < p.Lq ? p.delta[row_base + qi] : 0.f;
      }
      mbar_arrive(base + L::full(s));
      mbar_wait(base + L::do_empty, (i & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(base + L::do_full, kTile);
        tma_load_tile<D>(base + L::dout, &map_do, base + L::do_full, q0, h,
                         b, p.pos_do);
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: keys k0 .. k0 + 63, columns col0 .. col0 +
  // 127 of their dK and dV
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = tid / kConsumers;
  const int col0 = kN * wg;
  // the dO and Q columns its dV and dK products read: col0 / 64 atoms in
  const uint32_t cols = (col0 / 64) * kAtomBytes;
  const DkvRows rows(p, b, h, k0, tid);
  const float kept = kDropout ? p.drop.scale : 1.f;
  const float pm = kDropout ? pm_scale(kept) : 16384.f;  // pm_scale(1)
  const float kept_pm = kept * pm;  // exact: pm is a power of two
  float* const stash = reinterpret_cast<float*>(smem + L::stash) + tid;

  float dk[kN / 2], dv[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }

  consumer_wait(base + L::kv_full, 0, base + L::fault);
  for (int i = 0; i < n_iter; ++i) {
    const int s = i % kStages;
    const uint32_t phase = (i / kStages) & 1;
    const int q0 = (qt0 + i) * 64;
    // the dropout keep bits of this thread's 32 elements (one register),
    // drawn before the tile is waited for
    uint32_t keep = 0xffffffffu;
    if constexpr (kDropout) keep = rows.keep_bits(p, b, h, q0);
    consumer_wait(base + L::full(s), phase, base + L::fault);
    __syncwarp();

    // ---- P^T = exp(K Q^T * scale + bias - LSE), 0 where masked
    const float* lse_s = stats_ptr + L::stats(s) / 4;
    float st[32];
    wgmma_kmajor_product<D, __half>(st, opaque(base + L::k),
                                    opaque(base + L::q(s)));
    mbar_arrive(base + L::read(s));
    rows.probabilities(p, st, q0, k0, lse_s);

    // ---- dV[:, col0 ..] += (P M)^T dO[:, col0 ..], P M s as its float16
    // hi/lo pair
    consumer_wait(base + L::do_full, i & 1, base + L::fault);
    __syncwarp();
    wgmma_f16_pair_product<kN>(
        dv, [&](int e) { return (keep >> e) & 1u ? st[e] * kept_pm : 0.f; },
        base + L::dout + cols);
    // P^T waits in shared memory while dP^T takes its registers (beside dK
    // and dV, both score tiles in registers spilled)
#pragma unroll
    for (int e = 0; e < 32; ++e) stash[e * kGroupThreads] = st[e];

    // ---- dS^T = P^T (V dO^T M - Delta), in place of dP^T
    float dpt[32];
    wgmma_kmajor_product<D, __half>(dpt, opaque(base + L::v),
                                    opaque(base + L::dout));
    mbar_arrive(base + L::do_empty);
    rows.grad_scores([&](int e) { return stash[e * kGroupThreads]; }, dpt,
                     keep, kept, lse_s + 64);

    // ---- dK[:, col0 ..] += dS^T Q[:, col0 ..], Q as its two bf16 terms,
    // waited for here (the splitters have had P^T, dV and dP^T to make them)
    consumer_wait(base + L::terms(s), phase, base + L::fault);
    wgmma_split_pairs<kN>(dk, [&](int e) { return dpt[e]; },
                          base + L::q(s) + cols, base + L::q_lo + cols);
    mbar_arrive(base + L::empty(s));
  }

  // ---- dK * scale and dV / s, float16, through their strides; all NaN
  // if a consumer wait gave up
  const bool fault =
      *reinterpret_cast<volatile const uint32_t*>(smem + L::fault) != 0u;
  const float nan = __int_as_float(0x7fc00000);
  store_rows<kN>(p.out0 + b * p.out0_st[0] + h * p.out0_st[1] + col0,
                 p.out0_st[2], rows.kj0, rows.kj1, p.Lk, rows.t, dk,
                 fault ? nan : p.scale);
  store_rows<kN>(p.out1 + b * p.out1_st[0] + h * p.out1_st[1] + col0,
                 p.out1_st[2], rows.kj0, rows.kj1, p.Lk, rows.t, dv,
                 fault ? nan : 1.f / pm);
}

// ------------------------------------------------------------ launches
// The dQ (kDkv false: outputs dQ and dS) or dK/dV kernel (outputs dK and
// dV) at D = 256.
template <bool kDkv>
int run_bwd(const void* q, const void* k, const void* v, const void* bias,
            const void* dout, const void* lse, const void* delta, void* out0,
            void* out1, int B, int H, int Lq, int Lk, int head_dim,
            const unsigned long long* geo, const long long* strides,
            int causal, float scale, int dropout_enabled,
            unsigned long long seed, unsigned int threshold, float drop_scale,
            void* stream) {
  if (head_dim != D) return (int)cudaErrorInvalidValue;
  Params p;
  CUtensorMap m[4];
  cudaError_t err = make_bwd_params(
      p, m, kDkv ? 2 : 1, q, k, v, bias, dout, lse, delta, out0, out1, B, H,
      Lq, Lk, geo, strides, causal, scale, dropout_enabled, seed, threshold,
      drop_scale, CU_TENSOR_MAP_DATA_TYPE_FLOAT16);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = dropout_enabled != 0;
  if constexpr (kDkv) {
    static unsigned smem_set[2] = {0, 0};
    err = drop ? launch_bwd(flash_bwd_dkv_f16_d256_kernel<true>, kDkvThreads,
                            DkvLayout::kBytes, smem_set[1], m, p,
                            (p.Lk + 63) / 64, s)
               : launch_bwd(flash_bwd_dkv_f16_d256_kernel<false>, kDkvThreads,
                            DkvLayout::kBytes, smem_set[0], m, p,
                            (p.Lk + 63) / 64, s);
  } else {
    static unsigned smem_set[2] = {0, 0};
    err = drop ? launch_bwd(flash_bwd_dq_f16_d256_kernel<true>, kDqThreads,
                            DqLayout::kBytes, smem_set[1], m, p,
                            (p.Lq + 63) / 64, s)
               : launch_bwd(flash_bwd_dq_f16_d256_kernel<false>, kDqThreads,
                            DqLayout::kBytes, smem_set[0], m, p,
                            (p.Lq + 63) / 64, s);
  }
  return (int)err;
}

}  // namespace

// q, k, v, dout: float16 [B, H, L, 256] tensors read by TMA through the 14
// geometry words each in `geo` (q, k, v, dout in that order; sm90.cuh).
// lse and delta: float32 [B, H, Lq], contiguous. dq: float16, written
// through its (batch, head, row) element strides strides[0..2]; ds (may be
// null): float32 [B, H, Lq, Lk], contiguous; bias (may be null): float32,
// strides[3..5] (0 where broadcast). D: 256. Dropout as in
// pt_flash_attention_fwd. Returns the cudaError_t of the launch.
extern "C" int pt_flash_attention_bwd_dq_f16_d256_sm90(
    const void* q, const void* k, const void* v, const void* bias,
    const void* dout, const void* lse, const void* delta, void* dq, void* ds,
    int B, int H, int Lq, int Lk, int D, const unsigned long long* geo,
    const long long* strides, int causal, float scale, int dropout_enabled,
    unsigned long long seed, unsigned int threshold, float drop_scale,
    void* stream) {
  return run_bwd<false>(q, k, v, bias, dout, lse, delta, dq, ds, B, H, Lq,
                        Lk, D, geo, strides, causal, scale, dropout_enabled,
                        seed, threshold, drop_scale, stream);
}

// As pt_flash_attention_bwd_dq_f16_d256_sm90, writing dK and dV (float16,
// through strides[0..2] and [3..5]); bias strides in strides[6..8].
extern "C" int pt_flash_attention_bwd_dkv_f16_d256_sm90(
    const void* q, const void* k, const void* v, const void* bias,
    const void* dout, const void* lse, const void* delta, void* dk, void* dv,
    int B, int H, int Lq, int Lk, int D, const unsigned long long* geo,
    const long long* strides, int causal, float scale, int dropout_enabled,
    unsigned long long seed, unsigned int threshold, float drop_scale,
    void* stream) {
  return run_bwd<true>(q, k, v, bias, dout, lse, delta, dk, dv, B, H, Lq, Lk,
                       D, geo, strides, causal, scale, dropout_enabled, seed,
                       threshold, drop_scale, stream);
}
