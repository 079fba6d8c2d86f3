// Flash-attention backward, dQ (and dS) and dK/dV, for float32 inputs at
// head dim 256 on Hopper tensor cores (sm_90a): every float32 operand split
// into three bf16 terms, wgmma fed by TMA, CUDA C++ with plain C entries.
//
// Replaces: paddle_tpu/kernels/flash_attention.py `_bwd_dq_kernel` (:198,
// pallas_call at :466) and `_bwd_dkv_kernel` (:269, pallas_call at :513),
// both launched by `_flash_bwd_impl` (:411), with their in-kernel dropout
// (`_dropout_mask`, :120; here philox.cuh), for float32 q/k/v/dO at head
// dim 256. D 64/128 take flash_attention_bwd_f32_sm90.cu, bf16 inputs
// flash_attention_bwd_{dq,dkv}_sm90.cu, float16 inputs
// flash_attention_bwd_f16_d256_sm90.cu; the Python wrapper routes by
// (dtype, D, kernel). The float16 instantiation (float16's bf16 terms are
// exact) is on no route: the yardstick the float16 kernels are timed
// against.
//
// Computes what those kernels compute (flash_bwd_sm90.cuh): dQ and, when
// asked for, dS as float32 [B, H, Lq, Lk] with zeros on the tiles the
// causal mask skips; dK and dV; all three written through their strides
// in the inputs' type (float32, or float16 rounded once from the float32
// result). Numerics as flash_attention_bwd_f32_sm90.cu: q, k, v and dO
// arrive as their three bf16 terms from the split pre-pass, P M and dS are
// split in registers, each product keeps the six term pairs i + j <= 2, the
// small pairs accumulated first (sm90.cuh, "Order").
//
// Bound on an H100 at [1, 8, 1024, 256] causal (4.19 M kept pairs): dQ
// takes six term pairs of S = Q K^T, dP = dO V^T and dQ += dS K, 36 D FLOP
// a pair: 0.039 ms at 989 TFLOP/s; dK/dV the pairs of S^T, dP^T, dV and dK,
// 48 D FLOP a pair: 0.052 ms. Both are bound by operations; at this shape
// one CTA per 64-row tile fits the 132 SMs about once, so the longest
// causal CTA sets the time (dQ's last query tile: 16 key tiles of 37.7
// MFLOP, 0.078 ms at one SM's share of the peak).
//
// What D = 256 changes against D 64/128. One bf16 [64, 256] term tile is
// 32 KB and a CTA may use 227 KB: seven such tiles. The D 64/128 kernels
// keep both of the tile's own operands resident as their three terms (192
// KB here), which would leave room for one streamed entry. So only one
// operand stays resident (Q for dQ, K for dK/dV: 96 KB) and the other three
// stream through a ring of four 32 KB entries (128 KB), each operand read
// from L2 again where it is used again. Registers: dQ of 64 rows is 128
// floats a thread and dK + dV of 64 keys 256; only a lone warpgroup per SM
// gets more than 168 registers a thread on this toolkit (up to 255), so:
// - dQ: one CTA per (b, h, 64 query rows), one consumer warpgroup owning
//   all 256 columns of its rows' dQ, and a producer warp;
// - dK/dV: two CTAs per (b, h, 64 keys), each one consumer warpgroup and a
//   producer warp: one makes dK (S^T, dP^T, dS^T, dK += dS^T Q), the other
//   dV (S^T, dV += (P M)^T dO), so each holds one 128-float accumulator
//   and S^T is the only product made twice (1.25 times the tensor work of
//   one pass; the dK CTA does 3/5 of it). Splitting dK and dV by columns
//   instead (two CTAs each making S^T and dP^T whole and half of both
//   accumulators: 1.5 times the work) spilled (12 bytes, 124 with
//   dropout) at 255 registers, P^T, dP^T and both halves being live
//   together, and ran 16 % slower at [1, 8, 1024, 256] and 23 % at
//   [2, 8, 1024, 256] (PERF.md, section 6).
//
// The ring. Per loop tile (a key tile of dQ, a query tile of dK/dV) twelve
// term tiles stream, in the order they are used:
//   A2 A1 A0 | X2 X1 Y0 Y1 X0 Y2 | A2 A1 A0
// with dQ: A = K, X = V, Y = dO; dK: A = Q, X = V, Y = dO. A's terms make
// S (S^T) against the resident operand, smallest term first, and come again
// for dQ += dS K (dK += dS^T Q). The middle six make dP = Y X^T (dP^T =
// X Y^T) from their six term pairs, (Y0 X2), (Y0 X1), (Y1 X1), (Y1 X0),
// (Y2 X0) and the main pair (Y0 X0) last, holding at most four entries at a
// time. Entries are released out of order, so each entry has a fixed slot
// (kSlotOf below), chosen so that every entry's slot is freed at least one
// product before the entry is used: a ring filled in order (entry n in
// slot n % 4) would load the next tile's first A term only after the main
// dP pair. The dV CTA streams six, A2 A1 A0 (S^T) and dO2 dO1 dO0 (dV),
// in order.
//
// Per tile otherwise as the D 64/128 kernels: P on S's fragment, dS = P (dP
// M - Delta) in place of dP, stored as float32 when asked for; every split
// of a float32 matrix the kernel makes runs one 16-column slice at a time,
// right before that slice's wgmmas, each slice a commit group of its own
// (fb_by_slice), so only two slices' terms (24 registers) are live beside
// the accumulators. Query tiles of dQ are walked from the last and key
// tiles of dK/dV from the first, so the heaviest causal tiles start first;
// masks only on the diagonal and ragged tiles; dropout only in its own
// instantiation; rows past L arrive as zeros from TMA; no atomics, so a run
// replays bit for bit. The kernels allocate nothing and do not synchronise.

#include "philox.cuh"
#include "sm90.cuh"
#include "flash_bwd_sm90.cuh"

namespace {

using namespace pt_bwd_sm90;

constexpr int kD = 256;
constexpr int kThreads = kConsumers + 32;  // a warpgroup and a producer warp
constexpr uint32_t kTile = 64 * kD * 2;     // one bf16 [64, 256] term tile
constexpr int kRing = 4;
constexpr int kEntries = 12;  // ring entries per loop tile

// ------------------------------------------------------------ the schedule
// Twelve 2-bit fields, entry e at bits 2e.
template <typename... T>
constexpr uint32_t pack2(T... v) {
  uint32_t r = 0;
  int i = 0;
  ((r |= static_cast<uint32_t>(v) << (2 * i++)), ...);
  return r;
}
__host__ __device__ constexpr int field(uint32_t packed, int e) {
  return static_cast<int>((packed >> (2 * e)) & 3u);
}

// The streamed operands: A, X, Y (see the note at the top).
enum Operand { kA = 0, kX = 1, kY = 2 };

// Entry e of a loop tile: A2 A1 A0 X2 X1 Y0 Y1 X0 Y2 A2 A1 A0.
constexpr uint32_t kOperandOf = pack2(kA, kA, kA, kX, kX, kY, kY, kX, kY, kA,
                                      kA, kA);
constexpr uint32_t kTermOf = pack2(2, 1, 0, 2, 1, 0, 1, 0, 2, 2, 1, 0);
// Its slot, and its place among the slot's fills of one tile. A slot's
// entries follow one another: slot 0 takes entries 0, 3, 7 (A2, X2, X0:
// A2 is freed after S's first product and X2 needed two products later;
// X2 freed after dP's second pair and X0 needed at its fourth; X0 freed
// after the main pair and the next tile's A2 needed three products later),
// slot 1 entries 1, 4, 8, 10, slot 2 entries 2, 6, 9, slot 3 entries 5, 11.
// Every entry's slot is freed at least one product before the entry is
// used.
constexpr uint32_t kSlotOf = pack2(0, 1, 2, 0, 1, 3, 2, 0, 1, 2, 1, 3);
constexpr uint32_t kPlaceOf = pack2(0, 0, 0, 1, 1, 0, 1, 2, 2, 2, 3, 1);
constexpr uint32_t kFillsOf = pack2(3, 4, 3, 2);  // fills of slot s a tile

// Shared memory: the resident operand's three term tiles, the four ring
// slots, for dK/dV two buffers of 64 LSE and 64 Delta values, then the
// mbarriers. 230,504 bytes, + 1024 to align the base.
struct Layout {
  __host__ __device__ static constexpr uint32_t res(int a) { return kTile * a; }
  __host__ __device__ static constexpr uint32_t slot(int s) {
    return kTile * (kSplit + s);
  }
  static constexpr uint32_t kTiles = kTile * (kSplit + kRing);
  __host__ __device__ static constexpr uint32_t stats(int i) {
    return kTiles + 512 * i;
  }
  static constexpr uint32_t bars = kTiles + 1024;
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
  static constexpr size_t kBytes = bars + 8 * (5 + 2 * kRing) + 1024;
};
static_assert(Layout::kBytes <= 232448, "more than a CTA's shared memory");

// Which schedule a CTA's ring follows: with `full`, the twelve entries
// above in the slots of kSlotOf (dQ, and dK/dV's dK CTAs); else the six
// entries A2 A1 A0 Y2 Y1 Y0 of the dV CTAs, each released as soon as it is
// used, entry n of the CTA in slot n % 4.
struct Schedule {
  bool full;

  __device__ __forceinline__ int entries() const { return full ? kEntries : 6; }
  __device__ __forceinline__ int slot(int i, int e) const {
    return full ? field(kSlotOf, e) : (6 * i + e) % kRing;
  }
  // the fill of the slot that entry e of loop tile i is (fill k completes
  // phase k & 1 of the slot's barriers)
  __device__ __forceinline__ int fill(int i, int e) const {
    return full ? i * field(kFillsOf, field(kSlotOf, e)) + field(kPlaceOf, e)
                : (6 * i + e) / kRing;
  }
  __device__ __forceinline__ int operand(int e) const {
    return full ? field(kOperandOf, e) : e < kSplit ? kA : kY;
  }
  __device__ __forceinline__ int term(int e) const {
    return full ? field(kTermOf, e) : kSplit - 1 - e % kSplit;
  }
};

// The consumer's side of the ring.
struct Ring {
  uint32_t base;
  Schedule sched;

  // Wait for entry e of loop tile i; its tile address, opaque to the
  // compiler so that each wgmma descriptor is built where it is used.
  __device__ __forceinline__ uint32_t wait(int i, int e) const {
    const int s = sched.slot(i, e);
    mbar_wait(base + Layout::full(s), sched.fill(i, e) & 1);
    __syncwarp();
    uint32_t tile = base + Layout::slot(s);
    asm volatile("" : "+r"(tile));
    return tile;
  }
  // Entry e's products have completed: hand its slot back.
  __device__ __forceinline__ void release(int i, int e) const {
    mbar_arrive(base + Layout::empty(sched.slot(i, e)));
  }
};

// Where a streamed operand's rows come from.
struct Source {
  const CUtensorMap* map;
  TmaPos pos;
  int row;
};

// The producer lane's loads: with i0 == 0 first the resident operand's
// three terms at rows res_row, then the entries of loop tiles i0 .. i1 - 1
// in order, operand op of tile i from src(op, i).
template <typename Src>
__device__ __forceinline__ void produce(uint32_t base, Schedule sched, int B,
                                        const CUtensorMap* res, TmaPos res_pos,
                                        int res_row, int h, int b, int i0,
                                        int i1, Src src) {
  if (i0 == 0) {
    mbar_arrive_expect_tx(base + Layout::res_full, kSplit * kTile);
    for (int a = 0; a < kSplit; ++a)
      tma_load_tile<kD>(base + Layout::res(a), res, base + Layout::res_full,
                        res_row, h, a * B + b, res_pos);
  }
  for (int i = i0; i < i1; ++i)
    for (int e = 0; e < sched.entries(); ++e) {
      const int s = sched.slot(i, e);
      const Source x = src(sched.operand(e), i);
      mbar_wait(base + Layout::empty(s), (sched.fill(i, e) & 1) ^ 1);
      mbar_arrive_expect_tx(base + Layout::full(s), kTile);
      tma_load_tile<kD>(base + Layout::slot(s), x.map, base + Layout::full(s),
                        x.row, h, sched.term(e) * B + b, x.pos);
    }
}

// ------------------------------------------------------------ products
// acc (+)= A B^T for two K-major [64, 256] term tiles (one term pair, 16
// m64n64k16 wgmmas), committed and waited for; `first` overwrites acc.
__device__ __forceinline__ void pair_abt(float (&acc)[32], uint32_t ta,
                                         uint32_t tb, bool first) {
  fence_operand(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_ss_n64(acc, kmajor_desc(ta, kk), kmajor_desc(tb, kk),
                 !(first && kk == 0));
  wgmma_commit();
  wgmma_wait_all();
  fence_operand(acc);
}

// O += sum over a <= 2 - j of F_a B_j, waited for: F the float32 64 x 64
// matrix whose element e is `f(e)`, B_j the transposed (MN-major) [64, 256]
// term tile at tb. F is split one 16-column slice at a time, right before
// that slice's m64n256k16 wgmmas (the largest a first), each slice a commit
// group: the next slice is split while the last one's products run, and
// only two slices' terms (24 registers) are live. (One slice's terms at a
// time, with a wait per slice, measured 2-3 % slower.)
template <typename Elem>
__device__ __forceinline__ void fb_by_slice(float (&o)[kD / 2], Elem f,
                                            uint32_t tb, int j) {
  uint32_t fr[2][kSplit][4];
  fence_operand(o);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    split_slice(f, kk, fr[kk & 1]);
    wgmma_fence();
    const uint64_t desc = mnmajor_desc(tb, kk);
#pragma unroll
    for (int n = 0; n < kSplit; ++n) {
      const int a = kSplit - 1 - n;
      if (a + j < kSplit) wgmma_rs_n256_tb(o, fr[kk & 1][a], desc, 1);
    }
    wgmma_commit();
    if (kk > 0) {
      wgmma_wait_pending<1>();
      fence_fragments(fr[(kk - 1) & 1]);
    }
  }
  wgmma_wait_all();
  fence_fragments(fr[1]);
  fence_operand(o);
}

// dP (+)= the six term pairs of Y X^T (kYxT: dQ's dO V^T) or X Y^T (the dK
// CTAs' V dO^T) from entries 3 .. 8 of loop tile i (X2 X1 Y0 Y1 X0 Y2),
// the main pair Y0 X0 last, each entry released after its last pair.
template <bool kYxT>
__device__ __forceinline__ void dp_pairs(float (&dp)[32], const Ring& ring,
                                         int i) {
  const auto pair = [&](uint32_t ty, uint32_t tx, bool first) {
    // made opaque per pair: the compiler would otherwise keep a twice-used
    // tile's sixteen descriptors from one pair to the next (which spilled)
    asm volatile("" : "+r"(ty), "+r"(tx));
    if constexpr (kYxT)
      pair_abt(dp, ty, tx, first);
    else
      pair_abt(dp, tx, ty, first);
  };
  const uint32_t x2 = ring.wait(i, 3);
  const uint32_t x1 = ring.wait(i, 4);
  const uint32_t y0 = ring.wait(i, 5);
  pair(y0, x2, true);
  pair(y0, x1, false);
  ring.release(i, 3);
  const uint32_t y1 = ring.wait(i, 6);
  pair(y1, x1, false);
  ring.release(i, 4);
  const uint32_t x0 = ring.wait(i, 7);
  pair(y1, x0, false);
  ring.release(i, 6);
  const uint32_t y2 = ring.wait(i, 8);
  pair(y2, x0, false);
  ring.release(i, 8);
  pair(y0, x0, false);
  ring.release(i, 7);
  ring.release(i, 5);
}

// The dropout keep bits of a consumer thread's 32 score elements, element e
// at (query, key) = at(e), out-of-range elements kept. The seed is made
// opaque first, so that Philox's key schedule (20 words) is derived here,
// where few registers are live, and not hoisted out of the tile loop; the
// elements are drawn two at a time (eight at a time spilled the dropout
// dQ at 255 registers).
template <typename At, typename Params>
__device__ __forceinline__ uint32_t keep_bits(const Params& p, int b, int h,
                                              At at) {
  DropoutParams d = p.drop;
  uint32_t lo = static_cast<uint32_t>(d.seed);
  uint32_t hi = static_cast<uint32_t>(d.seed >> 32);
  asm volatile("" : "+r"(lo), "+r"(hi));
  d.seed = (static_cast<unsigned long long>(hi) << 32) | lo;
  uint32_t keep = 0xffffffffu;
#pragma unroll 1
  for (int e0 = 0; e0 < 32; e0 += 2)
#pragma unroll
    for (int e = e0; e < e0 + 2; ++e) {
      const int2 qk = at(e);
      if (qk.x < p.Lq && qk.y < p.Lk &&
          dropout_multiplier(d, b, h, qk.x, qk.y) == 0.f)
        keep &= ~(1u << e);
    }
  return keep;
}

__device__ __forceinline__ void init_barriers(uint32_t base, bool stats) {
  mbar_init(base + Layout::res_full, 1);
  for (int s = 0; s < kRing; ++s) {
    mbar_init(base + Layout::full(s), 1);
    mbar_init(base + Layout::empty(s), kConsumers);
  }
  if (stats)
    for (int i = 0; i < 2; ++i) {
      mbar_init(base + Layout::stats_full(i), 32);
      mbar_init(base + Layout::stats_empty(i), kConsumers);
    }
  fence_barrier_init();
}

// ------------------------------------------------------------ dQ
// One CTA per (b, h, 64 query rows); Q's terms resident; per key tile A =
// K, X = V, Y = dO (the tile's own rows). kDropout: the dropout draws are
// compiled only into the instantiation that uses them. Out: dQ's element
// type, float (float32 inputs) or __half (float16 inputs).
template <bool kDropout, typename Out>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_f32_d256_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const __grid_constant__ CUtensorMap map_do,
                             const BwdParams<Out> p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * 64;
  // causal: keys past the tile's last query row are masked for every row
  const int n_kt = ((p.causal ? min(p.Lk, q0 + 64) : p.Lk) + 63) / 64;
  const int tid = threadIdx.x;
  constexpr Schedule kSched{true};

  if (tid == 0) init_barriers(base, false);
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer: one lane issues every copy
    if (tid == kConsumers)
      produce(base, kSched, p.B, &map_q, p.pos_q, q0, h, b, 0, n_kt,
              [&](int op, int i) {
                return op == kA   ? Source{&map_k, p.pos_k, 64 * i}
                       : op == kX ? Source{&map_v, p.pos_v, 64 * i}
                                  : Source{&map_do, p.pos_do, q0};
              });
    return;
  }

  // ---- consumer warpgroup: query rows q0 .. q0 + 63
  const DqRows rows(p, b, h, q0, tid);
  const Ring ring{base, kSched};
  float dq[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dq[i] = 0.f;

  mbar_wait(base + Layout::res_full, 0);
  for (int i = 0; i < n_kt; ++i) {
    const int k0 = i * 64;
    uint32_t keep = 0xffffffffu;
    if constexpr (kDropout)
      keep = keep_bits(p, b, h, [&](int e) {
        return make_int2((e & 3) < 2 ? rows.qi0 : rows.qi1,
                         k0 + 8 * (e >> 2) + 2 * rows.t + (e & 1));
      });

    // ---- S = sum of Q_a K_j^T over a + j <= 2, K's terms 2, 1, 0
    float sc[32], dp[32];
#pragma unroll
    for (int e = 0; e < kSplit; ++e) {
      // Q's 48 descriptors made anew per K term, not kept across them
      uint32_t tq = base + Layout::res(0);
      asm volatile("" : "+r"(tq));
      terms_abt<kD>(sc, tq, ring.wait(i, e), kSplit - 1 - e, e == 0);
      ring.release(i, e);
    }
    rows.probabilities(p, sc, q0, k0);
    // ---- dP = sum of dO_a V_j^T, then dS = P (dP M - Delta) in its place
    dp_pairs<true>(dp, ring, i);
    rows.grad_scores(sc, dp, keep, kDropout ? p.drop.scale : 1.f);
    if (rows.dsb != nullptr) rows.store_ds(dp, k0, p.Lq, p.Lk);
    // ---- dQ += sum of dS_a K_j, K's terms 2, 1, 0 again
#pragma unroll
    for (int e = 9; e < kEntries; ++e) {
      fb_by_slice(dq, [&](int x) { return dp[x]; }, ring.wait(i, e),
                  kEntries - 1 - e);
      ring.release(i, e);
    }
  }

  if (rows.dsb != nullptr && p.causal && n_kt * 64 < p.Lk)
    rows.zero_unseen_ds(q0, n_kt, p.Lq, p.Lk, tid);
  store_rows<kD>(p.out0 + b * p.out0_st[0] + h * p.out0_st[1], p.out0_st[2],
                 rows.qi0, rows.qi1, p.Lq, rows.t, dq, p.scale);
}

// ------------------------------------------------------------ dK/dV
// Two CTAs per (b, h, 64 keys), blockIdx.z = 2 * key tile + role, the key
// tile the slowest grid dimension so the early (heaviest causal) tiles
// start first. Both make S^T against K's resident terms (A = Q); role 0
// then dP^T (X = V, the tile's own rows; Y = dO), dS^T and dK += dS^T Q,
// role 1 dV += (P M)^T dO (the six entries A2 A1 A0 Y2 Y1 Y0).
template <bool kDropout, typename Out>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_f32_d256_kernel(const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v,
                              const __grid_constant__ CUtensorMap map_do,
                              const BwdParams<Out> p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - smem_u32(smem_raw));
  const int h = blockIdx.x, b = blockIdx.y;
  const int k0 = (blockIdx.z >> 1) * 64;
  const bool dv_cta = blockIdx.z & 1;
  const Schedule sched{!dv_cta};
  // causal (top-left): query tile qt holds a kept pair of these keys iff
  // its last row reaches k0
  const int n_qt = (p.Lq + 63) / 64;
  const int qt0 = p.causal ? k0 / 64 : 0;
  const int n_iter = max(0, n_qt - qt0);
  const int tid = threadIdx.x;

  if (tid == 0) init_barriers(base, true);
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warp: lane 0 issues the copies, all 32 lanes copy each
    // query tile's LSE and Delta into a stats buffer
    const int lane = tid - kConsumers;
    const long long row_base = ((long long)b * p.H + h) * p.Lq;
    const auto src = [&](int op, int i) {
      const int q_row = (qt0 + i) * 64;
      return op == kA   ? Source{&map_q, p.pos_q, q_row}
             : op == kX ? Source{&map_v, p.pos_v, k0}
                        : Source{&map_do, p.pos_do, q_row};
    };
    for (int i = 0; i < n_iter; ++i) {
      const int q0 = (qt0 + i) * 64;
      mbar_wait(base + Layout::stats_empty(i & 1), ((i >> 1) & 1) ^ 1);
      float* st = reinterpret_cast<float*>(smem + Layout::stats(i & 1));
      for (int r = lane; r < 64; r += 32) {
        const int qi = q0 + r;
        st[r] = qi < p.Lq ? p.lse[row_base + qi] : 0.f;
        st[64 + r] = qi < p.Lq ? p.delta[row_base + qi] : 0.f;
      }
      mbar_arrive(base + Layout::stats_full(i & 1));
      if (lane == 0)
        produce(base, sched, p.B, &map_k, p.pos_k, k0, h, b, i, i + 1, src);
      __syncwarp();
    }
    return;
  }

  // ---- consumer warpgroup: keys k0 .. k0 + 63, all 256 columns of their
  // dK (role 0) or dV (role 1)
  const DkvRows rows(p, b, h, k0, tid);
  const Ring ring{base, sched};
  float acc[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;

  if (n_iter > 0) mbar_wait(base + Layout::res_full, 0);
  for (int i = 0; i < n_iter; ++i) {
    const int q0 = (qt0 + i) * 64;
    uint32_t keep = 0xffffffffu;
    if constexpr (kDropout)
      keep = keep_bits(p, b, h, [&](int e) {
        return make_int2(q0 + 8 * (e >> 2) + 2 * rows.t + (e & 1),
                         (e & 3) < 2 ? rows.kj0 : rows.kj1);
      });
    const float kept = kDropout ? p.drop.scale : 1.f;

    // ---- S^T = sum of K_a Q_j^T, Q's terms 2, 1, 0, then P^T
    float st[32];
#pragma unroll
    for (int e = 0; e < kSplit; ++e) {
      uint32_t tk = base + Layout::res(0);
      asm volatile("" : "+r"(tk));
      terms_abt<kD>(st, tk, ring.wait(i, e), kSplit - 1 - e, e == 0);
      ring.release(i, e);
    }
    mbar_wait(base + Layout::stats_full(i & 1), (i >> 1) & 1);
    const float* lse_s =
        reinterpret_cast<const float*>(smem + Layout::stats(i & 1));
    rows.probabilities(p, st, q0, k0, lse_s);

    if (dv_cta) {
      // ---- dV += sum of (P M)^T_a dO_j, dO's terms 2, 1, 0
      mbar_arrive(base + Layout::stats_empty(i & 1));
#pragma unroll
      for (int e = kSplit; e < 2 * kSplit; ++e) {
        fb_by_slice(
            acc, [&](int x) { return (keep >> x) & 1u ? st[x] * kept : 0.f; },
            ring.wait(i, e), 2 * kSplit - 1 - e);
        ring.release(i, e);
      }
      continue;
    }
    // ---- dP^T = sum of V_a dO_j^T, then dS^T = P^T (dP^T M - Delta)
    float dpt[32];
    dp_pairs<false>(dpt, ring, i);
    rows.grad_scores([&](int x) { return st[x]; }, dpt, keep, kept,
                     lse_s + 64);
    mbar_arrive(base + Layout::stats_empty(i & 1));
    // ---- dK += sum of dS^T_a Q_j, Q's terms 2, 1, 0 again
#pragma unroll
    for (int e = 9; e < kEntries; ++e) {
      fb_by_slice(acc, [&](int x) { return dpt[x]; }, ring.wait(i, e),
                  kEntries - 1 - e);
      ring.release(i, e);
    }
  }

  // ---- dK * scale or dV, through its strides
  if (dv_cta)
    store_rows<kD>(p.out1 + b * p.out1_st[0] + h * p.out1_st[1],
                   p.out1_st[2], rows.kj0, rows.kj1, p.Lk, rows.t, acc, 1.f);
  else
    store_rows<kD>(p.out0 + b * p.out0_st[0] + h * p.out0_st[1],
                   p.out0_st[2], rows.kj0, rows.kj1, p.Lk, rows.t, acc,
                   p.scale);
}

template <bool kDropout, typename Out>
cudaError_t launch_dq(const CUtensorMap (&m)[4], const BwdParams<Out>& p,
                      cudaStream_t stream) {
  static unsigned smem_set = 0;
  return launch_bwd(flash_bwd_dq_f32_d256_kernel<kDropout, Out>, kThreads,
                    Layout::kBytes, smem_set, m, p, (p.Lq + 63) / 64, stream);
}

template <bool kDropout, typename Out>
cudaError_t launch_dkv(const CUtensorMap (&m)[4], const BwdParams<Out>& p,
                       cudaStream_t stream) {
  static unsigned smem_set = 0;
  return launch_bwd(flash_bwd_dkv_f32_d256_kernel<kDropout, Out>, kThreads,
                    Layout::kBytes, smem_set, m, p, 2 * ((p.Lk + 63) / 64),
                    stream);
}

// The dQ (kDkv false: outputs dQ and dS) or dK/dV kernel (outputs dK and
// dV), its gradients of type Out.
template <bool kDkv, typename Out>
int run_bwd(const void* q3, const void* k3, const void* v3, const void* bias,
            const void* do3, const void* lse, const void* delta, void* out0,
            void* out1, int B, int H, int Lq, int Lk,
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
  if constexpr (kDkv)
    return (int)(dropout_enabled ? launch_dkv<true>(m, p, s)
                                 : launch_dkv<false>(m, p, s));
  else
    return (int)(dropout_enabled ? launch_dq<true>(m, p, s)
                                 : launch_dq<false>(m, p, s));
}

// run_bwd with the gradients' type picked by out_dtype: 0 float32, 2
// float16; D must be 256.
template <bool kDkv>
int run_bwd_as(int out_dtype, const void* q3, const void* k3, const void* v3,
               const void* bias, const void* do3, const void* lse,
               const void* delta, void* out0, void* out1, int B, int H,
               int Lq, int Lk, int D, const unsigned long long* geo,
               const long long* strides, int causal, float scale,
               int dropout_enabled, unsigned long long seed,
               unsigned int threshold, float drop_scale, void* stream) {
  if (D != kD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return run_bwd<kDkv, float>(q3, k3, v3, bias, do3, lse, delta, out0, out1,
                                B, H, Lq, Lk, geo, strides, causal, scale,
                                dropout_enabled, seed, threshold, drop_scale,
                                s);
  if (out_dtype == 2)
    return run_bwd<kDkv, __half>(q3, k3, v3, bias, do3, lse, delta, out0,
                                 out1, B, H, Lq, Lk, geo, strides, causal,
                                 scale, dropout_enabled, seed, threshold,
                                 drop_scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q3, k3, v3, do3: the bf16 terms of float32 (or float16) q, k, v, dO as
// pt_split_bf16_terms writes them ([3 B, H, L, 256]), read by TMA through
// the 14 geometry words each in `geo` (q3, k3, v3, do3 in that order;
// sm90.cuh). lse and delta: float32 [B, H, Lq], contiguous. dq: out_dtype 0
// float32, 2 float16, written through its (batch, head, row) element
// strides strides[0..2]; ds (may be null): float32 [B, H, Lq, Lk],
// contiguous; bias (may be null): float32, strides[3..5] (0 where
// broadcast). D: 256. Dropout as in pt_flash_attention_fwd. Returns the
// cudaError_t of the launch.
extern "C" int pt_flash_attention_bwd_dq_f32_d256_sm90(
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

// As pt_flash_attention_bwd_dq_f32_d256_sm90, writing dK and dV (of
// out_dtype, through strides[0..2] and [3..5]); bias strides in
// strides[6..8].
extern "C" int pt_flash_attention_bwd_dkv_f32_d256_sm90(
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
