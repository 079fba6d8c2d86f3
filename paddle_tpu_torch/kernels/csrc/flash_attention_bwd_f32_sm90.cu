// Flash-attention backward, dQ (and dS) and dK/dV, for float32 inputs on
// Hopper tensor cores (sm_90a): every float32 operand split into three bf16
// terms, wgmma fed by TMA, CUDA C++ with plain C entries.
//
// Replaces: paddle_tpu/kernels/flash_attention.py `_bwd_dq_kernel` (:198,
// pallas_call at :466) and `_bwd_dkv_kernel` (:269, pallas_call at :513),
// both launched by `_flash_bwd_impl` (:411), with their in-kernel dropout
// (`_dropout_mask`, :120; here philox.cuh), for float32 q/k/v/dO at head
// dims 64 and 128: the attention backward of float32 training, and of
// float16 training (the reference computes float16 inputs with float32
// operands too; their split into bf16 terms is exact, see
// flash_attention_fwd_f32_sm90.cu). bf16 inputs take
// flash_attention_bwd_{dq,dkv}_sm90.cu, D = 256
// flash_attention_bwd_f32_d256_sm90.cu; the Python wrapper routes by
// (dtype, D).
//
// Computes what those kernels compute (flash_bwd_sm90.cuh): dQ and, when
// asked for, dS as float32 [B, H, Lq, Lk] with zeros on the tiles the
// causal mask skips; dK and dV. The three gradients are written through
// their strides in the inputs' type: float32, or float16 rounded once from
// the float32 result (Out).
//
// Numerics: the reference takes every product with float32 operands
// (`_operand_dtype`, :42-59, under full float32 matmul precision). As in
// flash_attention_fwd_f32_sm90.cu, each float32 operand enters as three bf16
// terms x0 + x1 + x2 (|x - x0 - x1 - x2| <= 2^-24 |x|), and each product
// keeps the six term pairs i + j <= 2 (sm90.cuh, issue_terms_abt and
// issue_terms_fb): q, k, v and dO come as terms from the split pre-pass
// (pt_split_bf16_terms, [3 B, H, L, D] bf16, one TMA map per operand), and
// the float32 matrices the kernels make, P M and dS, are split in registers
// (split_slice).
//
// Bound on an H100: at [2, 16, 1024, 128] causal (16.79 M kept pairs), dQ
// takes six term pairs of S = Q K^T, dP = dO V^T and dQ += dS K, 36 D FLOP
// a pair: 0.0783 ms at 989 TFLOP/s; dK/dV the pairs of S^T, dP^T, dV and dK,
// 48 D FLOP a pair: 0.104 ms. Each reads its four term tensors (50 MB) and
// writes 17 or 34 MB: 0.020-0.025 ms. Both are bound by operations.
//
// Design. One CTA per (b, h, 64-row tile): query rows for dQ, key rows for
// dK/dV; one consumer warpgroup that owns the rows and their accumulators
// (dQ: D / 2 floats a thread; dK and dV: 2 x D / 2) and one producer warp.
// The tile's two own operands stay resident as their three terms each (Q
// and dO for dQ, K and V for dK/dV: six [64, D] tiles, 96 KB at D = 128).
// The other two stream by TMA as single term tiles, smallest term first
// (sm90.cuh says why), each released as soon as its products completed.
// One of them is used twice (K for S and for dS K; Q for S^T and for dS^T
// Q), the other once (V; dO for dP^T and dV in the same pass):
// - dQ holds K: two banks of three term tiles take turns (TermBanks), K's
//   terms in one (K2 K1 K0: S, then dS K), V's in the other (V2 V1 V0:
//   dP), and the next key tile's K loads into V's bank while dS K runs.
//   Six loads per key tile; with K loaded twice (nine) dQ measured 8 %
//   slower at D = 128 and 12 % at D = 64.
// - dK/dV loads Q twice, through a ring of six entries (four at D = 64) in
//   the order Q2 Q1 Q0 (S^T), dO2 dO1 dO0, Q2 Q1 Q0 (dK): at D = 64 it has
//   no room for a second bank set beside its P^T stash at two CTAs per SM,
//   and at one CTA per SM it measured 50 % slower (at D = 128 the banks
//   were 4 % faster).
// Shared memory at D = 128: 96 KB resident + 6 streamed tiles of 16 KB
// (+ for dK/dV the query tiles' LSE and Delta and P^T's 16 KB stash), one
// CTA per SM with up to 255 registers a thread. At D = 64 every tile is
// half as large: two CTAs per SM (168 registers), as the float32 forward
// runs, so that one CTA's exponentials and splits overlap the other's
// products.
//
// Per tile, dQ: S (the K terms), P, dP (the V terms), dS in place of dP
// (stored as float32 when asked for), dS's terms made once (48 registers),
// dQ += dS K (the K terms again). dK/dV: S^T, then P^T, which waits in
// shared memory; per dO term tile, dP^T += V dO^T and dV += (P M)^T dO,
// with (P M)^T split from the stash 32 columns at a time; then dS^T, its
// terms made once, and dK += dS^T Q. Splitting (P M)^T in halves keeps
// 24 fragment registers, not 48, beside dK, dV and dP^T: with all 48 the
// D = 64 kernel spilled at two CTAs per SM and the D = 128 dropout one at
// 255 registers.
//
// Otherwise as the bf16 kernels: query tiles of dQ walked from the last and
// key tiles of dK/dV from the first, so the heaviest causal tiles start
// first; masks only on the diagonal and ragged tiles; dropout only in its
// own instantiation, drawing the per-element Philox bits every kernel draws;
// rows past L arrive as zeros from TMA; no atomics, so a run replays bit for
// bit. The kernels allocate nothing and do not synchronise.

#include "philox.cuh"
#include "sm90.cuh"
#include "flash_bwd_sm90.cuh"

namespace {

using namespace pt_bwd_sm90;

constexpr int kThreads = kConsumers + 32;  // a warpgroup and a producer warp
constexpr int kLoadsPerTile = 3 * kSplit;  // Q2 Q1 Q0 dO2 dO1 dO0 Q2 Q1 Q0

// Entry n of the dK/dV ring: the twice-used operand ("A": Q) or the other
// ("B": dO), and its term, smallest first.
__host__ __device__ constexpr bool streams_a(int n) {
  return n % kLoadsPerTile < kSplit || n % kLoadsPerTile >= 2 * kSplit;
}
__host__ __device__ constexpr int streamed_term(int n) {
  return kSplit - 1 - n % kSplit;
}

// Shared memory of one CTA: the six resident term tiles, the streamed ones
// (dQ: TermBanks; dK/dV: the ring), for dK/dV two buffers of 64 LSE and 64
// Delta values and the P^T stash, then the mbarriers.
template <int D, bool kDkv>
struct Layout {
  static constexpr uint32_t kTile = 64 * D * 2;  // one bf16 [64, D] tile
  static constexpr int kRing = D == 64 && kDkv ? 4 : 6;
  // resident term tile i: the first own operand's terms 0..2, the second's
  // 3..5
  __host__ __device__ static constexpr uint32_t res(int i) {
    return kTile * i;
  }
  __host__ __device__ static constexpr uint32_t slot(int s) {
    return kTile * (2 * kSplit + s);
  }
  static constexpr uint32_t kTiles = kTile * (2 * kSplit + kRing);
  __host__ __device__ static constexpr uint32_t stats(int i) {
    return kTiles + 512 * i;
  }
  // word e of consumer thread tid at e * kConsumers + tid
  static constexpr uint32_t stash = kTiles + 1024;
  static constexpr uint32_t bars =
      kDkv ? stash + 4 * 32 * kConsumers : kTiles;
  static constexpr uint32_t res_full = bars;
  __host__ __device__ static constexpr uint32_t full(int s) {
    return bars + 8 * (1 + s);
  }
  __host__ __device__ static constexpr uint32_t empty(int s) {
    return bars + 8 * (1 + kRing + s);
  }
  __host__ __device__ static constexpr uint32_t stats_full(int i) {
    return bars + 8 * (1 + 2 * kRing + i);
  }
  __host__ __device__ static constexpr uint32_t stats_empty(int i) {
    return bars + 8 * (3 + 2 * kRing + i);
  }
  // + 1024: the base is aligned up to the swizzle atom
  static constexpr size_t kBytes = bars + 8 * (5 + 2 * kRing) + 1024;
};

// The consumer's side of the dK/dV ring: entry n in slot n % kRing, its k-th
// fill completing phase k & 1 of the slot's `full` barrier.
template <class L>
struct RingReader {
  uint32_t base;
  int n;

  // Wait for the next entry; its tile address, opaque to the compiler so
  // that each wgmma descriptor is built where it is used.
  __device__ __forceinline__ uint32_t acquire() {
    const int s = n % L::kRing;
    mbar_wait(base + L::full(s), (n / L::kRing) & 1);
    __syncwarp();
    uint32_t tile = base + L::slot(s);
    asm volatile("" : "+r"(tile));
    return tile;
  }

  // The entry's products have completed: hand its slot back.
  __device__ __forceinline__ void release() {
    mbar_arrive(base + L::empty(n % L::kRing));
    ++n;
  }
};

// The producer lane's loads: with n0 = 0 first the two resident operands'
// terms at rows row0 of (b, h); then ring entries n0 .. n1 - 1, entry n at
// rows row_of(n / kLoadsPerTile) of A or B.
template <int D, class L, typename RowOf, typename Params>
__device__ __forceinline__ void produce(uint32_t base, const Params& p,
                                        const CUtensorMap* res0, TmaPos pos0,
                                        const CUtensorMap* res1, TmaPos pos1,
                                        int row0, const CUtensorMap* map_a,
                                        TmaPos pos_a, const CUtensorMap* map_b,
                                        TmaPos pos_b, int h, int b, int n0,
                                        int n1, RowOf row_of) {
  if (n0 == 0) {
    mbar_arrive_expect_tx(base + L::res_full, 2 * kSplit * L::kTile);
    for (int a = 0; a < kSplit; ++a) {
      tma_load_tile<D>(base + L::res(a), res0, base + L::res_full, row0, h,
                       a * p.B + b, pos0);
      tma_load_tile<D>(base + L::res(kSplit + a), res1, base + L::res_full,
                       row0, h, a * p.B + b, pos1);
    }
  }
  for (int n = n0; n < n1; ++n) {
    const int s = n % L::kRing;
    const bool is_a = streams_a(n);
    const int term = streamed_term(n);
    mbar_wait(base + L::empty(s), ((n / L::kRing) & 1) ^ 1);
    mbar_arrive_expect_tx(base + L::full(s), L::kTile);
    tma_load_tile<D>(base + L::slot(s), is_a ? map_a : map_b, base + L::full(s),
                     row_of(n / kLoadsPerTile), h, term * p.B + b,
                     is_a ? pos_a : pos_b);
  }
}

// The dQ kernel's streamed tiles: two banks of three term tiles (ring slots
// 0-2 and 3-5) that take turns. Tile i's K terms are in bank i & 1, its V
// terms in the other, slot idx of a bank holding term 2 - idx. K stays
// until dS K, and the next tile's K loads into V's bank as soon as dP is
// done, so each operand is read once per tile. Every slot is filled once
// per tile: its k-th fill belongs to tile k, phase k & 1 of its barriers.
template <class L>
struct TermBanks {
  uint32_t base;

  __device__ __forceinline__ static int slot(int bank, int idx) {
    return kSplit * bank + idx;
  }
  // Term tile idx (term 2 - idx) of `bank`, opaque to the compiler so that
  // each wgmma descriptor is built where it is used.
  __device__ __forceinline__ uint32_t tile(int bank, int idx) const {
    uint32_t t = base + L::slot(slot(bank, idx));
    asm volatile("" : "+r"(t));
    return t;
  }
  __device__ __forceinline__ uint32_t wait(int bank, int idx, int i) const {
    mbar_wait(base + L::full(slot(bank, idx)), i & 1);
    __syncwarp();
    return tile(bank, idx);
  }
  __device__ __forceinline__ void release(int bank, int idx) const {
    mbar_arrive(base + L::empty(slot(bank, idx)));
  }
};

// The producer lane's loads into TermBanks: the resident operands as in
// produce, then per tile i of n0 .. n1 - 1 the terms 2, 1, 0 of A (K) into
// bank i & 1 and of B (V) into the other, at rows row_of(i).
template <int D, class L, typename RowOf, typename Params>
__device__ __forceinline__ void produce_banks(
    uint32_t base, const Params& p, const CUtensorMap* res0, TmaPos pos0,
    const CUtensorMap* res1, TmaPos pos1, int row0, const CUtensorMap* map_a,
    TmaPos pos_a, const CUtensorMap* map_b, TmaPos pos_b, int h, int b,
    int n0, int n1, RowOf row_of) {
  produce<D, L>(base, p, res0, pos0, res1, pos1, row0, map_a, pos_a, map_b,
                pos_b, h, b, n0, n0, row_of);
  for (int i = n0; i < n1; ++i) {
    for (int op = 0; op < 2; ++op) {
      const int bank = (i + op) & 1;
      for (int idx = 0; idx < kSplit; ++idx) {
        const int s = TermBanks<L>::slot(bank, idx);
        mbar_wait(base + L::empty(s), (i & 1) ^ 1);
        mbar_arrive_expect_tx(base + L::full(s), L::kTile);
        tma_load_tile<D>(base + L::slot(s), op == 0 ? map_a : map_b,
                         base + L::full(s), row_of(i), h,
                         (kSplit - 1 - idx) * p.B + b, op == 0 ? pos_a : pos_b);
      }
    }
  }
}

// Three dK/dV ring entries of an operand's terms j = 2, 1, 0, each passed
// to `use(tile, j, first)` (first: the first of the three) and released.
template <class L, typename Use>
__device__ __forceinline__ void each_term(RingReader<L>& ring, Use use) {
#pragma unroll
  for (int i = 0; i < kSplit; ++i) {
    const uint32_t tile = ring.acquire();
    use(tile, streamed_term(i), i == 0);
    ring.release();
  }
}

// ------------------------------------------------------------ dQ
// One CTA per (b, h, 64 query rows); kDropout: the dropout draws are
// compiled only into the instantiation that uses them. Out: dQ's element
// type, float (float32 inputs) or __half (float16 inputs).
template <int D, bool kDropout, typename Out>
__global__ void __launch_bounds__(kThreads, D == 64 && !kDropout ? 2 : 1)
flash_bwd_dq_f32_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const __grid_constant__ CUtensorMap map_do,
                             const BwdParams<Out> p) {
  using L = Layout<D, false>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * 64;
  // causal: keys past the tile's last query row are masked for every row
  const int n_kt = ((p.causal ? min(p.Lk, q0 + 64) : p.Lk) + 63) / 64;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(base + L::res_full, 1);
    for (int s = 0; s < L::kRing; ++s) {
      mbar_init(base + L::full(s), 1);
      mbar_init(base + L::empty(s), kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer: one lane issues every copy
    if (tid == kConsumers)
      produce_banks<D, L>(base, p, &map_q, p.pos_q, &map_do, p.pos_do, q0,
                          &map_k, p.pos_k, &map_v, p.pos_v, h, b, 0, n_kt,
                          [](int i) { return 64 * i; });
    return;
  }

  // ---- consumer warpgroup: query rows q0 .. q0 + 63
  const DqRows rows(p, b, h, q0, tid);
  const TermBanks<L> banks{base};
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  mbar_wait(base + L::res_full, 0);
  for (int i = 0; i < n_kt; ++i) {
    const int k0 = i * 64;
    uint32_t keep = 0xffffffffu;
    if constexpr (kDropout) keep = rows.keep_bits(p, b, h, k0);
    uint32_t tq = base + L::res(0), tdo = base + L::res(kSplit);
    asm volatile("" : "+r"(tq), "+r"(tdo));

    // ---- S = sum of Q_a K_j^T over a + j <= 2, then P
    float sc[32], dp[32];
    const int bank_k = i & 1, bank_v = bank_k ^ 1;
#pragma unroll
    for (int idx = 0; idx < kSplit; ++idx)
      terms_abt<D>(sc, tq, banks.wait(bank_k, idx, i), kSplit - 1 - idx,
                   idx == 0);
    rows.probabilities(p, sc, q0, k0);
    // ---- dP = sum of dO_a V_j^T, then dS = P (dP M - Delta) in its place
#pragma unroll
    for (int idx = 0; idx < kSplit; ++idx) {
      terms_abt<D>(dp, tdo, banks.wait(bank_v, idx, i), kSplit - 1 - idx,
                   idx == 0);
      banks.release(bank_v, idx);
    }
    rows.grad_scores(sc, dp, keep, kDropout ? p.drop.scale : 1.f);
    if (rows.dsb != nullptr) rows.store_ds(dp, k0, p.Lq, p.Lk);
    // ---- dQ += sum of dS_a K_j, dS's terms made once
    uint32_t f[4][kSplit][4];
    split_all([&](int e) { return dp[e]; }, f);
#pragma unroll
    for (int idx = 0; idx < kSplit; ++idx) {
      terms_fb<D>(dq, f, banks.tile(bank_k, idx), kSplit - 1 - idx);
      banks.release(bank_k, idx);
    }
  }

  if (rows.dsb != nullptr && p.causal && n_kt * 64 < p.Lk)
    rows.zero_unseen_ds(q0, n_kt, p.Lq, p.Lk, tid);
  store_rows<D>(p.out0 + b * p.out0_st[0] + h * p.out0_st[1], p.out0_st[2],
                rows.qi0, rows.qi1, p.Lq, rows.t, dq, p.scale);
}

// ------------------------------------------------------------ dK/dV
// One CTA per (b, h, 64 keys), the key tile the slowest grid dimension so
// the early (heaviest causal) tiles of every (b, h) start first.
template <int D, bool kDropout, typename Out>
__global__ void __launch_bounds__(kThreads, D == 64 && !kDropout ? 2 : 1)
flash_bwd_dkv_f32_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v,
                              const __grid_constant__ CUtensorMap map_do,
                              const BwdParams<Out> p) {
  using L = Layout<D, true>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - smem_u32(smem_raw));
  const int h = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * 64;
  // causal (top-left): query tile qt holds a kept pair of these keys iff
  // its last row reaches k0
  const int n_qt = (p.Lq + 63) / 64;
  const int qt0 = p.causal ? k0 / 64 : 0;
  const int n_iter = max(0, n_qt - qt0);
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(base + L::res_full, 1);
    for (int s = 0; s < L::kRing; ++s) {
      mbar_init(base + L::full(s), 1);
      mbar_init(base + L::empty(s), kConsumers);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(base + L::stats_full(i), 32);
      mbar_init(base + L::stats_empty(i), kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warp: lane 0 issues the copies, all 32 lanes copy each
    // query tile's LSE and Delta into a stats buffer
    const int lane = tid - kConsumers;
    const long long row_base = ((long long)b * p.H + h) * p.Lq;
    const auto q_row = [&](int i) { return (qt0 + i) * 64; };
    for (int i = 0; i < n_iter; ++i) {
      const int q0 = q_row(i);
      mbar_wait(base + L::stats_empty(i & 1), ((i >> 1) & 1) ^ 1);
      float* st = reinterpret_cast<float*>(smem + L::stats(i & 1));
      for (int r = lane; r < 64; r += 32) {
        const int qi = q0 + r;
        st[r] = qi < p.Lq ? p.lse[row_base + qi] : 0.f;
        st[64 + r] = qi < p.Lq ? p.delta[row_base + qi] : 0.f;
      }
      mbar_arrive(base + L::stats_full(i & 1));
      if (lane == 0)
        produce<D, L>(base, p, &map_k, p.pos_k, &map_v, p.pos_v, k0, &map_q,
                      p.pos_q, &map_do, p.pos_do, h, b, i * kLoadsPerTile,
                      (i + 1) * kLoadsPerTile, q_row);
      __syncwarp();
    }
    if (lane == 0 && n_iter == 0)  // the resident loads the consumers wait for
      produce<D, L>(base, p, &map_k, p.pos_k, &map_v, p.pos_v, k0, &map_q,
                    p.pos_q, &map_do, p.pos_do, h, b, 0, 0, q_row);
    return;
  }

  // ---- consumer warpgroup: keys k0 .. k0 + 63
  const DkvRows rows(p, b, h, k0, tid);
  RingReader<L> ring{base, 0};
  float* const stash = reinterpret_cast<float*>(smem + L::stash) + tid;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }

  mbar_wait(base + L::res_full, 0);
  for (int i = 0; i < n_iter; ++i) {
    const int q0 = (qt0 + i) * 64;
    uint32_t keep = 0xffffffffu;
    if constexpr (kDropout) keep = rows.keep_bits(p, b, h, q0);
    const float kept = kDropout ? p.drop.scale : 1.f;
    uint32_t tk = base + L::res(0), tv = base + L::res(kSplit);
    asm volatile("" : "+r"(tk), "+r"(tv));

    // ---- S^T = sum of K_a Q_j^T, then P^T, which waits in shared memory
    float st[32];
    each_term(ring, [&](uint32_t tq, int j, bool first) {
      terms_abt<D>(st, tk, tq, j, first);
    });
    mbar_wait(base + L::stats_full(i & 1), (i >> 1) & 1);
    const float* lse_s = reinterpret_cast<const float*>(smem + L::stats(i & 1));
    rows.probabilities(p, st, q0, k0, lse_s);
#pragma unroll
    for (int e = 0; e < 32; ++e) stash[e * kConsumers] = st[e];

    // ---- per dO term: dP^T += V_a dO_j^T and dV += (P M)^T_a dO_j. (P M)^T
    // is split from the stash twice per term, 32 columns at a time, so
    // that only half its fragments are live beside dK, dV and dP^T.
    const auto pm = [&](int e) {
      return (keep >> e) & 1u ? stash[e * kConsumers] * kept : 0.f;
    };
    float dpt[32];
    each_term(ring, [&](uint32_t tdo, int j, bool first) {
      uint32_t h[2][kSplit][4];
      split_all<0, 2>(pm, h);
      fence_operand(dpt);
      fence_operand(dv);
      wgmma_fence();
      issue_terms_abt<D>(dpt, tv, tdo, j, first);
      issue_terms_fb<D, 0, 2>(dv, h, tdo, j);
      wgmma_commit();
      wgmma_wait_all();
      fence_terms(h, j);
      fence_operand(dpt);
      split_all<2, 2>(pm, h);
      wgmma_fence();
      issue_terms_fb<D, 2, 2>(dv, h, tdo, j);
      wgmma_commit();
      wgmma_wait_all();
      fence_terms(h, j);
      fence_operand(dv);
    });

    // ---- dS^T = P^T (dP^T M - Delta);  dK += sum of dS^T_a Q_j
    rows.grad_scores([&](int e) { return stash[e * kConsumers]; }, dpt, keep,
                     kept, lse_s + 64);
    mbar_arrive(base + L::stats_empty(i & 1));
    uint32_t f[4][kSplit][4];
    split_all([&](int e) { return dpt[e]; }, f);
    each_term(ring, [&](uint32_t tq, int j, bool) {
      terms_fb<D>(dk, f, tq, j);
    });
  }

  rows.store<D>(p, b, h, dk, dv);
}

template <int D, bool kDropout, typename Out>
cudaError_t launch_dq(const CUtensorMap (&m)[4], const BwdParams<Out>& p,
                      cudaStream_t stream) {
  static unsigned smem_set = 0;
  return launch_bwd(flash_bwd_dq_f32_sm90_kernel<D, kDropout, Out>,
                    kThreads, Layout<D, false>::kBytes, smem_set, m, p,
                    (p.Lq + 63) / 64, stream);
}

template <int D, bool kDropout, typename Out>
cudaError_t launch_dkv(const CUtensorMap (&m)[4], const BwdParams<Out>& p,
                       cudaStream_t stream) {
  static unsigned smem_set = 0;
  return launch_bwd(flash_bwd_dkv_f32_sm90_kernel<D, kDropout, Out>,
                    kThreads, Layout<D, true>::kBytes, smem_set, m, p,
                    (p.Lk + 63) / 64, stream);
}

// The dQ (kDkv false: outputs dQ and dS) or dK/dV kernel (outputs dK and
// dV) at D 64 or 128, its gradients of type Out.
template <bool kDkv, typename Out>
int run_bwd(const void* q3, const void* k3, const void* v3, const void* bias,
            const void* do3, const void* lse, const void* delta, void* out0,
            void* out1, int B, int H, int Lq, int Lk, int D,
            const unsigned long long* geo, const long long* strides,
            int causal, float scale, int dropout_enabled,
            unsigned long long seed, unsigned int threshold, float drop_scale,
            cudaStream_t s) {
  BwdParams<Out> p;
  CUtensorMap m[4];
  const cudaError_t err = make_bwd_params(
      p, m, kDkv ? 2 : 1, q3, k3, v3, bias, do3, lse, delta, out0, out1, B,
      H, Lq, Lk, geo, strides, causal, scale, dropout_enabled, seed,
      threshold, drop_scale);
  if (err != cudaSuccess) return (int)err;
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

// run_bwd with the gradients' type picked by out_dtype: 0 float32, 2
// float16.
template <bool kDkv>
int run_bwd_as(int out_dtype, const void* q3, const void* k3, const void* v3,
               const void* bias, const void* do3, const void* lse,
               const void* delta, void* out0, void* out1, int B, int H,
               int Lq, int Lk, int D, const unsigned long long* geo,
               const long long* strides, int causal, float scale,
               int dropout_enabled, unsigned long long seed,
               unsigned int threshold, float drop_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return run_bwd<kDkv, float>(q3, k3, v3, bias, do3, lse, delta, out0, out1,
                                B, H, Lq, Lk, D, geo, strides, causal, scale,
                                dropout_enabled, seed, threshold, drop_scale,
                                s);
  if (out_dtype == 2)
    return run_bwd<kDkv, __half>(q3, k3, v3, bias, do3, lse, delta, out0,
                                 out1, B, H, Lq, Lk, D, geo, strides, causal,
                                 scale, dropout_enabled, seed, threshold,
                                 drop_scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q3, k3, v3, do3: the bf16 terms of float32 (or float16) q, k, v, dO as
// pt_split_bf16_terms writes them ([3 B, H, L, D]), read by TMA through the
// 14 geometry words each in `geo` (q3, k3, v3, do3 in that order; sm90.cuh).
// lse and delta: float32 [B, H, Lq], contiguous. dq: out_dtype 0 float32,
// 2 float16, written through its (batch, head, row) element strides
// strides[0..2]; ds (may be null): float32 [B, H, Lq, Lk], contiguous; bias
// (may be null): float32, strides[3..5] (0 where broadcast). D: 64 or 128.
// Dropout as in pt_flash_attention_fwd. Returns the cudaError_t of the
// launch.
extern "C" int pt_flash_attention_bwd_dq_f32_sm90(
    const void* q3, const void* k3, const void* v3, const void* bias,
    const void* do3, const void* lse, const void* delta, void* dq, void* ds,
    int B, int H, int Lq, int Lk, int D,
    const unsigned long long* geo, const long long* strides, int causal,
    float scale, int dropout_enabled, unsigned long long seed,
    unsigned int threshold, float drop_scale, int out_dtype, void* stream) {
  return run_bwd_as<false>(out_dtype, q3, k3, v3, bias, do3, lse, delta, dq,
                           ds, B, H, Lq, Lk, D, geo, strides, causal, scale,
                           dropout_enabled, seed, threshold, drop_scale,
                           stream);
}

// As pt_flash_attention_bwd_dq_f32_sm90, writing dK and dV (of out_dtype,
// through strides[0..2] and [3..5]); bias strides in strides[6..8].
extern "C" int pt_flash_attention_bwd_dkv_f32_sm90(
    const void* q3, const void* k3, const void* v3, const void* bias,
    const void* do3, const void* lse, const void* delta, void* dk, void* dv,
    int B, int H, int Lq, int Lk, int D,
    const unsigned long long* geo, const long long* strides, int causal,
    float scale, int dropout_enabled, unsigned long long seed,
    unsigned int threshold, float drop_scale, int out_dtype, void* stream) {
  return run_bwd_as<true>(out_dtype, q3, k3, v3, bias, do3, lse, delta, dk,
                          dv, B, H, Lq, Lk, D, geo, strides, causal, scale,
                          dropout_enabled, seed, threshold, drop_scale,
                          stream);
}
