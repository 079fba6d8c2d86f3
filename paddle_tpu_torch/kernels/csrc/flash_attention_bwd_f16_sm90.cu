// Flash-attention backward, dQ (and dS) and dK/dV, for float16 inputs on
// Hopper tensor cores (sm_90a): native float16 wgmma fed by TMA, CUDA C++
// with plain C entries.
//
// Replaces: paddle_tpu/kernels/flash_attention.py `_bwd_dq_kernel` (:198,
// pallas_call at :466) and `_bwd_dkv_kernel` (:269, pallas_call at :513),
// both launched by `_flash_bwd_impl` (:411), with their in-kernel dropout
// (`_dropout_mask`, :120; here philox.cuh), for float16 q/k/v/dO at head
// dims 64 and 128: the attention backward of float16 (O2) training. The
// float16 forward has its own native kernel
// (flash_attention_fwd_f16_sm90.cu), and so has the float16 backward at
// D = 256 (flash_attention_bwd_f16_d256_sm90.cu). The Python wrapper routes
// by (dtype, D, kernel).
//
// Computes what the other backward kernels compute (flash_bwd_sm90.cuh):
// dQ and, when asked for, dS as float32 [B, H, Lq, Lk] with zeros on the
// tiles the causal mask skips; dK and dV. The three gradients are rounded
// once to float16, from float32, as they are written through their strides.
//
// Numerics. The reference takes every product with float32 operands
// (`_operand_dtype`, :42-59). A product of two float16 values has at most
// 22 significant bits, exact in the float32 accumulator of a
// wgmma ...f32.f16.f16, so S = Q K^T and dP = dO V^T (S^T and dP^T in
// dK/dV) are one native product each: the float32-operand product up to
// summation order. Only the products with a float32 matrix the kernels make
// need more:
// - dS K and dS^T Q. dS has float32's range (dO carries the loss scale, so
//   dP may pass float16's 65504 where float32 does not overflow), so dS
//   enters as three bf16 terms (sm90.cuh split_slice), never as float16,
//   and the float16 operand as its two bf16 terms, which are exact (11
//   significant bits against bf16's 8, and bf16 has float32's exponents).
//   The kernels make those terms in shared memory from the TMA tile: both
//   types are 2 bytes and the 128-byte swizzle moves bytes, so an element
//   keeps its byte offset and the descriptors see the layout they expect.
//   Of the six term pairs the five with a + j <= 2 are kept (the dropped
//   one is of order 2^-24 |ds k|), in the float32 kernels' order, small
//   pairs before the main one (sm90.cuh, "Order").
// - (P M)^T dO. P M <= 1 / (1 - p) is bounded, so it enters as a float16
//   hi/lo pair of P M s: s a power of two that keeps P M s below 2^15,
//   hi = f16(P M s), lo = f16(P M s - hi) (sm90.cuh, "float16 pair"). That
//   is two native products, and dV is multiplied by 1 / s (exact) as it is
//   stored. The pair is within 2^-22 of each element down to P M ~ 2^-14 /
//   s, and within 2^-25 / s absolute below (s = 2^14 without dropout and at
//   p < 1/2). (Three bf16 terms of P M against dO's two would be five
//   products and dO's second term, two more [64, D] tiles, which the dK/dV
//   CTA has no room for at D = 128 beside Q's.)
//
// Design, from the bf16 kernels (flash_attention_bwd_{dq,dkv}_sm90.cu):
// - dQ: one CTA per (b, h, 64 query rows), the query tile the slowest grid
//   dimension, walked from the last; one consumer warpgroup and a producer
//   warp, two CTAs per SM (168 registers a thread; the dropout
//   instantiation one). The producer loads Q and dO once and streams K and V
//   tiles of 64 keys through 2-stage rings. Per key tile: S = Q K^T and P;
//   dP = dO V^T and dS = P (dP M - Delta), stored as float32 when asked
//   for; then K's stage becomes K's first bf16 term and V's stage, which dP
//   has read, its second (a named barrier before, a proxy fence and a named
//   barrier after), dQ += dS K with the five pairs, and both stages are
//   released. The CTA takes no more shared memory than the bf16 one (96 KB
//   at D = 128). Its 168 registers are tight at D = 128: the tile pass
//   unrolled twice, or the tile addresses made opaque at each product
//   instead of once per key tile, spilled 8 to 16 bytes.
// - dK/dV: one CTA per (b, h, 128 keys), 384 threads: two consumer
//   warpgroups of 64 keys each, with their dK and dV in registers, and a
//   producer warpgroup. Warp 8 streams Q and dO by TMA through a 2-stage
//   ring and copies each query tile's LSE and Delta into the stage; warps
//   9-11 make Q's bf16 terms: once both consumer warpgroups' S^T have read a
//   stage's Q (an mbarrier of 256 arrivals), the first term in place and the
//   second into the stage's own extra tile, then an mbarrier the consumers
//   wait on after dV, where no score tile is live. So the consumers never
//   wait for each other, and the terms are made while they run P^T and dV.
//   Per query tile: S^T = K Q^T
//   and P^T; dV += (P M)^T dO as the hi/lo pair; P^T waits in shared memory
//   while dP^T = V dO^T is made; dS^T; dK += dS^T Q with the five pairs. K,
//   V, the ring, Q's second terms and the P^T stash take 195 KB at D = 128:
//   one CTA per SM. As in the bf16 kernel the producer warpgroup hands
//   registers to the consumers (setmaxnreg 40 / 232); without that the
//   D = 128 instantiations spilled 720 and 948 bytes and ran 2.1 and 1.8
//   times slower (PERF.md, section 6).
// - masks only on the diagonal and ragged tiles; dropout only in its own
//   instantiation, drawing the per-element Philox bits every kernel draws;
//   rows and keys past L arrive as zeros from TMA, keys past Lk get P = 0
//   and rows past Lq dS = 0; no atomics, so a run replays bit for bit.
//
// Bound on an H100 at [2, 16, 1024, 128] causal (16.79 M kept pairs): dQ
// runs 7 products of 2 D FLOP a pair (S, dP and five for dS K; the bf16 dQ
// 5), 0.0304 ms at 989 TFLOP/s; dK/dV 9 (S^T, dP^T, two for dV, five for
// dK; the bf16 one 8), 0.0391 ms. The least work, one float16 product each
// (6 D and 8 D FLOP a pair), is 0.0130 and 0.0174 ms; their bytes (q, k,
// v and dO read once, the gradients written once) 0.0125 and 0.0150 ms.
//
// The kernels allocate nothing and do not synchronise.

#include "philox.cuh"
#include "sm90.cuh"
#include "flash_bwd_sm90.cuh"

namespace {

using namespace pt_bwd_sm90;
using Params = BwdParams<__half>;

constexpr int kStages = 2;

// ------------------------------------------------------------ dQ
constexpr int kDqThreads = kConsumers + 32;  // a warpgroup and a producer warp
constexpr int kSplitBarrier = 1;  // named barrier of the dQ consumers

template <int D>
struct DqLayout {
  static constexpr uint32_t kTile = 64 * D * 2;  // bytes of one [64, D] tile
  static constexpr uint32_t q = 0, dout = kTile;
  __host__ __device__ static constexpr uint32_t k(int s) {
    return kTile * (2 + s);
  }
  __host__ __device__ static constexpr uint32_t v(int s) {
    return kTile * (2 + kStages + s);
  }
  static constexpr uint32_t bars = kTile * (2 + 2 * kStages);
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

// kDropout: the dropout draws are compiled only into the instantiation that
// uses them, which runs one CTA per SM (at two its 168 registers spill, as
// the bf16 one's do).
template <int D, bool kDropout>
__global__ void __launch_bounds__(kDqThreads, kDropout ? 1 : 2)
flash_bwd_dq_f16_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const __grid_constant__ CUtensorMap map_do,
                             const Params p) {
  using L = DqLayout<D>;
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
      mbar_init(base + L::k_empty(s), kConsumers);
      mbar_init(base + L::v_empty(s), kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer: one lane issues every copy
    if (tid != kConsumers) return;
    mbar_arrive_expect_tx(base + L::qd_full, 2 * L::kTile);
    tma_load_tile<D>(base + L::q, &map_q, base + L::qd_full, q0, h, b,
                     p.pos_q);
    tma_load_tile<D>(base + L::dout, &map_do, base + L::qd_full, q0, h, b,
                     p.pos_do);
    for (int i = 0; i < n_kt; ++i) {
      const int s = i % kStages;
      const uint32_t free_phase = ((i / kStages) & 1) ^ 1;
      mbar_wait(base + L::k_empty(s), free_phase);
      mbar_arrive_expect_tx(base + L::k_full(s), L::kTile);
      tma_load_tile<D>(base + L::k(s), &map_k, base + L::k_full(s), i * 64, h,
                       b, p.pos_k);
      mbar_wait(base + L::v_empty(s), free_phase);
      mbar_arrive_expect_tx(base + L::v_full(s), L::kTile);
      tma_load_tile<D>(base + L::v(s), &map_v, base + L::v_full(s), i * 64, h,
                       b, p.pos_v);
    }
    return;
  }

  // ---- consumer warpgroup: query rows q0 .. q0 + 63
  const DqRows rows(p, b, h, q0, tid);
  const float kept = kDropout ? p.drop.scale : 1.f;
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  mbar_wait(base + L::qd_full, 0);
  for (int i = 0; i < n_kt; ++i) {
    const int s = i % kStages;
    const uint32_t phase = (i / kStages) & 1;
    const int k0 = i * 64;
    // the dropout keep bits of this thread's 32 elements (one register),
    // drawn before the tile is waited for
    uint32_t keep = 0xffffffffu;
    if constexpr (kDropout) keep = rows.keep_bits(p, b, h, k0);
    // the tiles' addresses, opaque to the compiler once per key tile, so
    // that each wgmma descriptor is built where it is used and not held
    // across the loop
    uint32_t tq = base + L::q, tdo = base + L::dout, tk = base + L::k(s),
             tv = base + L::v(s);
    asm volatile("" : "+r"(tq), "+r"(tdo), "+r"(tk), "+r"(tv));

    // ---- S = Q K^T, then P
    mbar_wait(base + L::k_full(s), phase);
    __syncwarp();
    float sc[32], dp[32];
    wgmma_kmajor_product<D, __half>(sc, tq, tk);
    rows.probabilities(p, sc, q0, k0);

    // ---- dP = dO V^T, then dS = P (dP M - Delta) in its place
    mbar_wait(base + L::v_full(s), phase);
    __syncwarp();
    wgmma_kmajor_product<D, __half>(dp, tdo, tv);
    rows.grad_scores(sc, dp, keep, kept);
    if (rows.dsb != nullptr) rows.store_ds(dp, k0, p.Lq, p.Lk);

    // ---- K's bf16 terms: the first in place of K, the second in V's
    // stage, once every warp's S and dP have read them
    named_barrier_sync(kSplitBarrier, kConsumers);
    split_f16_tile<D, kConsumers>(smem + L::k(s), smem + L::v(s), tid);
    fence_proxy_async_smem();
    named_barrier_sync(kSplitBarrier, kConsumers);

    // ---- dQ += dS K: dS's three bf16 terms against K's two
    wgmma_split_pairs<D>(dq, [&](int e) { return dp[e]; }, tk, tv);
    mbar_arrive(base + L::k_empty(s));
    mbar_arrive(base + L::v_empty(s));
  }

  if (rows.dsb != nullptr && p.causal && n_kt * 64 < p.Lk)
    rows.zero_unseen_ds(q0, n_kt, p.Lq, p.Lk, tid);
  // ---- dQ * scale, float16, through its strides
  store_rows<D>(p.out0 + b * p.out0_st[0] + h * p.out0_st[1], p.out0_st[2],
                rows.qi0, rows.qi1, p.Lq, rows.t, dq, p.scale);
}

// ------------------------------------------------------------ dK/dV
constexpr int kGroups = 2;                          // consumer warpgroups
constexpr int kDkvConsumers = kConsumers * kGroups;  // warps 0-7
constexpr int kSplitters = 96;                      // warps 9-11
constexpr int kDkvThreads = kDkvConsumers + 128;    // + a producer warpgroup
// Registers a thread: the CTA launches with 168 (65536 / 384); the producer
// warpgroup gives 128 of them back and the consumers take them
// (setmaxnreg), which the compiler counts on where it allocates the
// consumers' registers.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert((168 - kProducerRegs) * 128 >=
                  (kConsumerRegs - 168) * kDkvConsumers,
              "the producer must free what the consumers take");

template <int D>
struct DkvLayout {
  static constexpr uint32_t kTile = 64 * D * 2;
  // K and V of 64-key tile g (one per consumer warpgroup)
  __host__ __device__ static constexpr uint32_t k(int g) { return kTile * g; }
  __host__ __device__ static constexpr uint32_t v(int g) {
    return kTile * (kGroups + g);
  }
  // the ring: Q (in place, after S^T: its first bf16 term) and dO of stage
  // s, and the stage's second bf16 term of Q
  __host__ __device__ static constexpr uint32_t q(int s) {
    return kTile * (2 * kGroups + 2 * s);
  }
  __host__ __device__ static constexpr uint32_t dout(int s) {
    return kTile * (2 * kGroups + 2 * s + 1);
  }
  __host__ __device__ static constexpr uint32_t q_lo(int s) {
    return kTile * (2 * kGroups + 2 * kStages + s);
  }
  static constexpr uint32_t kTiles = kTile * (2 * kGroups + 3 * kStages);
  // per stage: 64 floats of LSE, then 64 of Delta
  __host__ __device__ static constexpr uint32_t stats(int s) {
    return kTiles + 512 * s;
  }
  // each consumer thread's 32 values of P^T and its dropout keep bits,
  // parked while dP^T is made (word e of thread tid at
  // e * kDkvConsumers + tid)
  static constexpr uint32_t stash = kTiles + 512 * kStages;
  static constexpr uint32_t bars = stash + 4 * 33 * kDkvConsumers;
  static constexpr uint32_t kv_full = bars;
  __host__ __device__ static constexpr uint32_t full(int s) {
    return bars + 8 * (1 + s);
  }
  __host__ __device__ static constexpr uint32_t empty(int s) {
    return bars + 8 * (1 + kStages + s);
  }
  // both warpgroups' S^T have read the stage's float16 Q
  __host__ __device__ static constexpr uint32_t read(int s) {
    return bars + 8 * (1 + 2 * kStages + s);
  }
  // the stage's Q terms are made
  __host__ __device__ static constexpr uint32_t terms(int s) {
    return bars + 8 * (1 + 3 * kStages + s);
  }
  static constexpr size_t kBytes = bars + 8 * (1 + 4 * kStages) + 1024;
};

template <int D, bool kDropout>
__global__ void __launch_bounds__(kDkvThreads, 1)
flash_bwd_dkv_f16_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v,
                              const __grid_constant__ CUtensorMap map_do,
                              const Params p) {
  using L = DkvLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - smem_u32(smem_raw));
  const float* stats_ptr = reinterpret_cast<const float*>(smem);

  // The key tile is the slowest grid dimension, so the early (heaviest
  // causal) tiles of every (b, h) start first.
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * 64 * kGroups;
  // causal (top-left): query tile qt holds a kept pair of these keys iff its
  // last row reaches k0
  const int n_qt = (p.Lq + 63) / 64;
  const int qt0 = p.causal ? k0 / 64 : 0;
  const int n_iter = max(0, n_qt - qt0);
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(base + L::kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(base + L::full(s), 1 + 32);
      mbar_init(base + L::empty(s), kDkvConsumers);
      mbar_init(base + L::read(s), kDkvConsumers);
      mbar_init(base + L::terms(s), kSplitters);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kDkvConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int lane = tid - kDkvConsumers;
    if (lane >= 32) {
      // ---- warps 9-11: each stage's Q as its two bf16 terms, once the
      // tile has landed and both warpgroups' S^T have read it
      for (int i = 0; i < n_iter; ++i) {
        const int s = i % kStages;
        const uint32_t phase = (i / kStages) & 1;
        mbar_wait(base + L::full(s), phase);
        mbar_wait(base + L::read(s), phase);
        split_f16_tile<D, kSplitters>(smem + L::q(s), smem + L::q_lo(s),
                                      lane - 32);
        fence_proxy_async_smem();
        mbar_arrive(base + L::terms(s));
      }
      return;
    }
    // ---- warp 8: lane 0 issues the TMA copies, all 32 lanes copy the
    // tile's LSE and Delta rows
    const long long row_base = ((long long)b * p.H + h) * p.Lq;
    if (lane == 0) {
      mbar_arrive_expect_tx(base + L::kv_full, 2 * kGroups * L::kTile);
      for (int g = 0; g < kGroups; ++g) {
        tma_load_tile<D>(base + L::k(g), &map_k, base + L::kv_full,
                         k0 + 64 * g, h, b, p.pos_k);
        tma_load_tile<D>(base + L::v(g), &map_v, base + L::kv_full,
                         k0 + 64 * g, h, b, p.pos_v);
      }
    }
    for (int i = 0; i < n_iter; ++i) {
      const int s = i % kStages;
      const int q0 = (qt0 + i) * 64;
      mbar_wait(base + L::empty(s), ((i / kStages) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(base + L::full(s), 2 * L::kTile);
        tma_load_tile<D>(base + L::q(s), &map_q, base + L::full(s), q0, h, b,
                         p.pos_q);
        tma_load_tile<D>(base + L::dout(s), &map_do, base + L::full(s), q0, h,
                         b, p.pos_do);
      }
      float* st = const_cast<float*>(stats_ptr) + (L::stats(s) / 4);
#pragma unroll
      for (int r = lane; r < 64; r += 32) {
        const int qi = q0 + r;
        st[r] = qi < p.Lq ? p.lse[row_base + qi] : 0.f;
        st[64 + r] = qi < p.Lq ? p.delta[row_base + qi] : 0.f;
      }
      // the full barriers complete in tile order: a consumer that has
      // waited for tile i knows that tile i - 1 has landed too (see the
      // causal skip below)
      if (i > 0)
        mbar_wait(base + L::full((i - 1) % kStages), ((i - 1) / kStages) & 1);
      mbar_arrive(base + L::full(s));
    }
    return;
  }

  // ---- consumer warpgroup wg: keys kw0 .. kw0 + 63, their dK and dV
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = tid / kConsumers;
  const int kw0 = k0 + 64 * wg;
  const uint32_t tile_k = base + L::k(wg), tile_v = base + L::v(wg);
  const DkvRows rows(p, b, h, kw0, tid);
  const float kept = kDropout ? p.drop.scale : 1.f;
  const float pm = kDropout ? pm_scale(kept) : 16384.f;  // pm_scale(1)
  const float kept_pm = kept * pm;  // exact: pm is a power of two
  float* const stash = reinterpret_cast<float*>(smem + L::stash) + tid;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }

  mbar_wait(base + L::kv_full, 0);
  for (int i = 0; i < n_iter; ++i) {
    const int s = i % kStages;
    const uint32_t phase = (i / kStages) & 1;
    const int q0 = (qt0 + i) * 64;
    if (p.causal && q0 + 63 < kw0) {
      // every pair of this query tile is masked for these keys: only the
      // second warpgroup, and only at its first tile. It releases the stage
      // without waiting for the tile, as the bf16 kernel does; its next wait
      // on the stage is for the phase after this one, which cannot pass
      // early (the full barriers complete in tile order).
      mbar_arrive(base + L::read(s));
      mbar_arrive(base + L::empty(s));
      continue;
    }
    uint32_t keep = 0xffffffffu;
    if constexpr (kDropout) keep = rows.keep_bits(p, b, h, q0);
    mbar_wait(base + L::full(s), phase);
    __syncwarp();

    // ---- P^T = exp(K Q^T * scale + bias - LSE), 0 where masked
    const float* lse_s = stats_ptr + L::stats(s) / 4;
    float st[32];
    wgmma_kmajor_product<D, __half>(st, opaque(tile_k),
                                    opaque(base + L::q(s)));
    mbar_arrive(base + L::read(s));
    rows.probabilities(p, st, q0, kw0, lse_s);

    // ---- dV += (P M)^T dO, P M s as its float16 hi/lo pair
    wgmma_f16_pair_product<D>(
        dv, [&](int e) { return (keep >> e) & 1u ? st[e] * kept_pm : 0.f; },
        base + L::dout(s));
    // P^T waits in shared memory while dP^T takes its registers
#pragma unroll
    for (int e = 0; e < 32; ++e) stash[e * kDkvConsumers] = st[e];
    if constexpr (kDropout)
      reinterpret_cast<uint32_t*>(stash)[32 * kDkvConsumers] = keep;
    // Q's terms, waited for here, where no score tile is live (the
    // splitters have had S^T's exponentials and dV to make them)
    mbar_wait(base + L::terms(s), phase);

    // ---- dS^T = P^T (V dO^T M - Delta);  dK += dS^T Q
    float dpt[32];
    wgmma_kmajor_product<D, __half>(dpt, opaque(tile_v),
                                    opaque(base + L::dout(s)));
    if constexpr (kDropout)
      keep = reinterpret_cast<const uint32_t*>(stash)[32 * kDkvConsumers];
    rows.grad_scores([&](int e) { return stash[e * kDkvConsumers]; }, dpt,
                     keep, kept, lse_s + 64);
    wgmma_split_pairs<D>(dk, [&](int e) { return dpt[e]; }, base + L::q(s),
                         base + L::q_lo(s));
    mbar_arrive(base + L::empty(s));
  }

  // ---- dK * scale and dV / s, float16, through their strides
  store_rows<D>(p.out0 + b * p.out0_st[0] + h * p.out0_st[1], p.out0_st[2],
                rows.kj0, rows.kj1, p.Lk, rows.t, dk, p.scale);
  store_rows<D>(p.out1 + b * p.out1_st[0] + h * p.out1_st[1], p.out1_st[2],
                rows.kj0, rows.kj1, p.Lk, rows.t, dv, 1.f / pm);
}

// ------------------------------------------------------------ launches
template <int D, bool kDropout>
cudaError_t launch_dq(const CUtensorMap (&m)[4], const Params& p,
                      cudaStream_t stream) {
  static unsigned smem_set = 0;
  return launch_bwd(flash_bwd_dq_f16_sm90_kernel<D, kDropout>, kDqThreads,
                    DqLayout<D>::kBytes, smem_set, m, p, (p.Lq + 63) / 64,
                    stream);
}

template <int D, bool kDropout>
cudaError_t launch_dkv(const CUtensorMap (&m)[4], const Params& p,
                       cudaStream_t stream) {
  static unsigned smem_set = 0;
  constexpr int kKeys = 64 * kGroups;  // per CTA
  return launch_bwd(flash_bwd_dkv_f16_sm90_kernel<D, kDropout>, kDkvThreads,
                    DkvLayout<D>::kBytes, smem_set, m, p,
                    (p.Lk + kKeys - 1) / kKeys, stream);
}

// The dQ (kDkv false: outputs dQ and dS) or dK/dV kernel (outputs dK and
// dV) at D 64 or 128.
template <bool kDkv>
int run_bwd(const void* q, const void* k, const void* v, const void* bias,
            const void* dout, const void* lse, const void* delta, void* out0,
            void* out1, int B, int H, int Lq, int Lk, int D,
            const unsigned long long* geo, const long long* strides,
            int causal, float scale, int dropout_enabled,
            unsigned long long seed, unsigned int threshold, float drop_scale,
            void* stream) {
  Params p;
  CUtensorMap m[4];
  const cudaError_t err = make_bwd_params(
      p, m, kDkv ? 2 : 1, q, k, v, bias, dout, lse, delta, out0, out1, B, H,
      Lq, Lk, geo, strides, causal, scale, dropout_enabled, seed, threshold,
      drop_scale, CU_TENSOR_MAP_DATA_TYPE_FLOAT16);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = dropout_enabled != 0;
  if constexpr (kDkv) {
    if (D == 64)
      return (int)(drop ? launch_dkv<64, true>(m, p, s)
                        : launch_dkv<64, false>(m, p, s));
    if (D == 128)
      return (int)(drop ? launch_dkv<128, true>(m, p, s)
                        : launch_dkv<128, false>(m, p, s));
  } else {
    if (D == 64)
      return (int)(drop ? launch_dq<64, true>(m, p, s)
                        : launch_dq<64, false>(m, p, s));
    if (D == 128)
      return (int)(drop ? launch_dq<128, true>(m, p, s)
                        : launch_dq<128, false>(m, p, s));
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, dout: float16 [B, H, L, D] tensors read by TMA through the 14
// geometry words each in `geo` (q, k, v, dout in that order; sm90.cuh).
// lse and delta: float32 [B, H, Lq], contiguous. dq: float16, written
// through its (batch, head, row) element strides strides[0..2]; ds (may be
// null): float32 [B, H, Lq, Lk], contiguous; bias (may be null): float32,
// strides[3..5] (0 where broadcast). D: 64 or 128. Dropout as in
// pt_flash_attention_fwd. Returns the cudaError_t of the launch.
extern "C" int pt_flash_attention_bwd_dq_f16_sm90(
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

// As pt_flash_attention_bwd_dq_f16_sm90, writing dK and dV (float16,
// through strides[0..2] and [3..5]); bias strides in strides[6..8].
extern "C" int pt_flash_attention_bwd_dkv_f16_sm90(
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
