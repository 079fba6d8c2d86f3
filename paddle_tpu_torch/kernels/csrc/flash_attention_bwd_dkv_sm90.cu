// Flash-attention backward, dK and dV, for bf16 inputs on Hopper tensor
// cores (sm_90a): wgmma fed by TMA, CUDA C++ with a plain C entry.
//
// Replaces: paddle_tpu/kernels/flash_attention.py `_bwd_dkv_kernel` (:269,
// pallas_call at :513 in `_flash_bwd_impl`, :411), for bf16 q/k/v/dO at
// head dims 64, 128 and 256. float32 inputs take
// flash_attention_bwd_f32_sm90.cu (D 64/128) or
// flash_attention_bwd_f32_d256_sm90.cu (D = 256); the Python wrapper routes
// by (dtype, D, kernel). The score-tile code is shared with the other Hopper backward
// kernels (flash_bwd_sm90.cuh).
//
// Computes what the FMA dK/dV kernel computes, per (b, h) and key tile: with
// P = exp(S * scale + bias - LSE) (0 above the top-left causal diagonal and
// past the ragged edge), M the dropout multiplier (philox.cuh; 1 without
// dropout) and Delta = rowsum(dO * O) from the caller,
//   dV = (P * M)^T dO,   dK = (P * (dO V^T * M - Delta))^T Q * scale,
// written in bf16 through their strides.
//
// Numerics: as in flash_attention_fwd_sm90.cu, the reference's default
// float32 operands (:316-327) are kept. S^T = K Q^T and dP^T = V dO^T are
// bf16 x bf16 products, exact in the float32 accumulator; the float32
// matrices the kernel makes, (P * M)^T and dS^T, enter their products as
// three bf16 terms each (sm90.cuh split_slice), which is the
// float32-operand product to 2^-24 of sum |x y|, float32's own rounding.
//
// Bound on an H100: per kept (query, key) pair 8 D FLOP (K Q^T, V dO^T,
// P^T dO, dS^T Q; 16 D on the tensor cores with the three-term split)
// against a few bytes per row: at the training shape [2, 16, 1024, 128]
// causal it is bound by operations, about 17 us of bf16 tensor-core work
// (35 us with the split), where the FMA kernel took 0.87 ms on the CUDA
// cores.
//
// Design:
// - one CTA per (b, h, 128-key tile), the tile index the slowest grid
//   dimension so the early (heaviest causal) tiles of every (b, h) start
//   first; 384 threads: two consumer warpgroups (warps 0-7), each owning 64
//   key rows and their dK and dV accumulators (2 x D / 2 floats a thread),
//   and a producer warpgroup (warps 8-11) of which warp 8 works. The CTA
//   launches with 168 registers a thread; setmaxnreg asks to take the
//   producer warpgroup down to 40 and the consumers up to 232, but this
//   toolkit's ptxas allocates no more than the launch's 168 to either, so
//   the kernel is written to fit 168 (two warpgroups of this size on an SM
//   measured 1.9 times faster than one warpgroup per CTA at the training
//   shape);
// - the producer loads both warpgroups' K and V once, then streams the
//   query tiles from the diagonal on: Q and dO by TMA into a 2-stage ring
//   shared by the two warpgroups, and the 64 rows of LSE and Delta, which
//   its 32 lanes copy into the same stage; the stage's `full` barrier
//   completes on the TMA bytes and the 33 arrivals, its `empty` barrier on
//   the 256 consumer threads (a warpgroup whose keys a causal query tile
//   cannot see arrives without computing);
// - per query tile: the thread's 32 dropout keep bits (one register), drawn
//   while the tile is in flight; S^T = K Q^T (m64n64k16 wgmmas, both
//   operands K-major in shared memory) and P^T on the accumulator fragment;
//   dV += (P M)^T dO with (P M)^T as register A fragments, made 16 columns
//   at a time (m64nDk16, dO the transposed B operand); then dP^T = V dO^T,
//   dS^T = P^T (dP^T M - Delta) and dK += dS^T Q the same way. P^T and the
//   keep bits wait in shared memory while dP^T is made, so at most 32 score
//   values and one slice of fragments are live beside dK and dV: no spills
//   within the 168 registers;
// - D = 256 (DkvShape): dK and dV of 64 keys would be 256 floats a thread,
//   so the two warpgroups own the same 64 keys (a CTA per 64-key tile) and
//   a 128-column half of dK and dV each: the dV and dK products read that
//   half of the dO and Q tiles (the descriptor starts two atoms in,
//   sm90.cuh), while each warpgroup makes S^T and dP^T whole (1.25 times
//   the tensor work of one pass). K, V and the two-stage ring take 192 KB,
//   which leaves no room for the keep bits' word beside P^T: a dropped
//   element is parked negated instead (P^T >= 0, so its sign bit is the
//   mask). A CTA per key tile and D half with one warpgroup and a producer
//   warp (255 registers) measured 6 % faster at [1, 8, 1024, 256] and 1.6
//   times slower at [2, 16, 1024, 256] causal, and with two warpgroups and
//   a one-stage ring it spilled (PERF.md, section 6);
// - dK is scaled once at the end; no atomics, so a run replays bit for bit;
// - the dropout bits are the per-element Philox words of (seed, b, h, query,
//   key), the same the forward and the FMA dQ kernel draw.
//
// The kernel allocates nothing and does not synchronise.

#include "philox.cuh"
#include "sm90.cuh"
#include "flash_bwd_sm90.cuh"

namespace {

using namespace pt_bwd_sm90;
using DkvParams = BwdParams<__nv_bfloat16>;

constexpr int kStages = 2;
constexpr int kGroups = 2;  // consumer warpgroups
constexpr int kDkvConsumers = 128 * kGroups;
constexpr int kThreads = kDkvConsumers + 128;  // + one producer warpgroup
// Registers a thread: a CTA of 384 threads launches with 168 each (65536 /
// 384); the producer warpgroup gives 128 of them back (setmaxnreg) for
// the 256 consumer threads to grow to 232 (which this toolkit's ptxas does
// not use; see the design note).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert((168 - kProducerRegs) * 128 >=
                  (kConsumerRegs - 168) * kDkvConsumers,
              "the producer must free what the consumers take");

// Per head dim: at D 64/128 each consumer warpgroup owns a 64-key tile and
// all D columns of its dK and dV; at D = 256 (kSplitD) both own one 64-key
// tile and kN = 128 columns each.
template <int D>
struct DkvShape {
  static constexpr bool kSplitD = D == 256;
  static constexpr int kN = kSplitD ? D / 2 : D;  // dK, dV columns owned
  static constexpr int kKeyTiles = kSplitD ? 1 : kGroups;  // per CTA
  // words a consumer thread parks: P^T, and the keep bits unless they
  // travel in P^T's sign bits
  static constexpr int kStashWords = kSplitD ? 32 : 33;
};

template <int D>
struct DkvLayout {
  using S = DkvShape<D>;
  static constexpr uint32_t kTile = 64 * D * 2;
  // K and V of 64-key tile g
  __host__ __device__ static constexpr uint32_t k(int g) { return kTile * g; }
  __host__ __device__ static constexpr uint32_t v(int g) {
    return kTile * (S::kKeyTiles + g);
  }
  __host__ __device__ static constexpr uint32_t q(int s) {
    return kTile * (2 * S::kKeyTiles + 2 * s);
  }
  __host__ __device__ static constexpr uint32_t dout(int s) {
    return kTile * (2 * S::kKeyTiles + 2 * s + 1);
  }
  // per stage: 64 floats of LSE, then 64 of Delta
  static constexpr uint32_t kRing = kTile * (2 * S::kKeyTiles + 2 * kStages);
  __host__ __device__ static constexpr uint32_t stats(int s) {
    return kRing + 512 * s;
  }
  // each consumer thread's 32 values of P^T and (D 64/128) its dropout
  // keep bits, parked while dP^T is made (word e of thread tid at
  // e * kDkvConsumers + tid)
  static constexpr uint32_t stash = kRing + 512 * kStages;
  static constexpr uint32_t bars =
      stash + 4 * S::kStashWords * kDkvConsumers;
  static constexpr uint32_t kv_full = bars;
  __host__ __device__ static constexpr uint32_t full(int s) {
    return bars + 8 * (1 + s);
  }
  __host__ __device__ static constexpr uint32_t empty(int s) {
    return bars + 8 * (1 + kStages + s);
  }
  static constexpr size_t kBytes = bars + 8 * (1 + 2 * kStages) + 1024;
};

// kDropout: the dropout draws are compiled only into the instantiation that
// uses them.
template <int D, bool kDropout>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do,
                          const DkvParams p) {
  using S = DkvShape<D>;
  using L = DkvLayout<D>;
  constexpr int kN = S::kN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - smem_u32(smem_raw));
  const float* stats_ptr = reinterpret_cast<const float*>(smem);

  // The key tile is the slowest grid dimension, so the early (heaviest
  // causal) tiles of every (b, h) start first.
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * 64 * S::kKeyTiles;
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
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kDkvConsumers) {
    // ---- producer warpgroup: its first warp works (lane 0 issues the TMA
    // copies, all 32 lanes copy the tile's LSE and Delta rows); the other
    // three only give their registers back
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int lane = tid - kDkvConsumers;
    if (lane >= 32) return;
    const long long row_base = ((long long)b * p.H + h) * p.Lq;
    if (lane == 0) {
      mbar_arrive_expect_tx(base + L::kv_full, 2 * S::kKeyTiles * L::kTile);
      for (int g = 0; g < S::kKeyTiles; ++g) {
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
  } else {
    // ---- consumer warpgroups: warpgroup wg owns keys kw0 .. kw0 + 63 and
    // columns col0 .. col0 + kN - 1 of their dK and dV
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = tid / 128;
    const int key_tile = S::kSplitD ? 0 : wg;
    const int kw0 = k0 + 64 * key_tile;
    const int col0 = S::kSplitD ? kN * wg : 0;
    const uint32_t tile_k = base + L::k(key_tile),
                   tile_v = base + L::v(key_tile);
    // the dO and Q columns its dV and dK products read: col0 / 64 atoms in
    const uint32_t cols = (col0 / 64) * kAtomBytes;
    const DkvRows rows(p, b, h, kw0, tid);

    float dk[kN / 2], dv[kN / 2];
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) {
      dk[i] = 0.f;
      dv[i] = 0.f;
    }

    mbar_wait(base + L::kv_full, 0);
    for (int i = 0; i < n_iter; ++i) {
      const int s = i % kStages;
      const int q0 = (qt0 + i) * 64;
      if (p.causal && q0 + 63 < kw0) {
        // every pair of this query tile is masked for these keys. Only the
        // second warpgroup at D 64/128 skips, and only the first tile: it
        // releases the stage without waiting for the tile (a wait here, or
        // any other reshaping of this loop tried so far, spills the D 128
        // and 256 kernels). Its next wait on the stage is for the phase
        // after this one; it cannot pass early, since the wait for tile 1
        // before it returns only once tile 0 has landed (the producer
        // completes the full barriers in tile order).
        mbar_arrive(base + L::empty(s));
        continue;
      }
      // the dropout keep bits of this thread's 32 elements (one register, so
      // the Philox words are drawn once and no float mask stays live),
      // drawn before the tile is waited for
      uint32_t keep = 0xffffffffu;
      if constexpr (kDropout) keep = rows.keep_bits(p, b, h, q0);
      mbar_wait(base + L::full(s), (i / kStages) & 1);
      __syncwarp();

      // ---- P^T = exp(K Q^T * scale + bias - LSE), 0 where masked
      const float* lse_s = stats_ptr + L::stats(s) / 4;
      float st[32];
      wgmma_kmajor_product<D>(st, tile_k, base + L::q(s));
      rows.probabilities(p, st, q0, kw0, lse_s);
      const float kept = kDropout ? p.drop.scale : 1.f;

      // ---- dV += (P M)^T dO, (P M)^T made slice by slice
      const auto mul = [&](int e) { return (keep >> e) & 1u ? kept : 0.f; };
      wgmma_split_product<kN, true>(
          dv, [&](int e) { return st[e] * mul(e); }, base + L::dout(s) + cols);
      // P^T waits in shared memory while dP^T takes its registers: with dK
      // and dV live, holding both score tiles would spill. At D = 256 a
      // dropped element is parked negated (its sign bit is the mask).
      constexpr bool kSigned = kDropout && S::kSplitD;
      float* stash = reinterpret_cast<float*>(smem + L::stash) + tid;
#pragma unroll
      for (int e = 0; e < 32; ++e)
        stash[e * kDkvConsumers] =
            kSigned && !((keep >> e) & 1u) ? -st[e] : st[e];
      if constexpr (kDropout && !S::kSplitD)
        reinterpret_cast<uint32_t*>(stash)[32 * kDkvConsumers] = keep;

      // ---- dS^T = P^T (V dO^T M - Delta);  dK += dS^T Q
      float dpt[32];
      wgmma_kmajor_product<D>(dpt, tile_v, base + L::dout(s));
      if constexpr (kSigned) {
        keep = 0u;
#pragma unroll
        for (int e = 0; e < 32; ++e)
          keep |= ((__float_as_uint(stash[e * kDkvConsumers]) >> 31) ^ 1u)
                  << e;
      } else if constexpr (kDropout) {
        keep = reinterpret_cast<const uint32_t*>(stash)[32 * kDkvConsumers];
      }
      rows.grad_scores(
          [&](int e) {
            const float x = stash[e * kDkvConsumers];
            return kSigned ? fabsf(x) : x;
          },
          dpt, keep, kept, lse_s + 64);
      wgmma_split_product<kN, true>(dk, [&](int e) { return dpt[e]; },
                                    base + L::q(s) + cols);
      mbar_arrive(base + L::empty(s));
    }

    // ---- dK * scale and dV, bf16, through their strides
    rows.store<kN>(p, b, h, dk, dv, col0);
  }
}

template <int D, bool kDropout>
cudaError_t launch(const CUtensorMap (&maps)[4], const DkvParams& p,
                   cudaStream_t stream) {
  static unsigned smem_set = 0;
  constexpr int kKeys = 64 * DkvShape<D>::kKeyTiles;  // per CTA
  return launch_bwd(flash_bwd_dkv_sm90_kernel<D, kDropout>, kThreads,
                    DkvLayout<D>::kBytes, smem_set, maps, p,
                    (p.Lk + kKeys - 1) / kKeys, stream);
}

}  // namespace

// q, k, v, dout: bf16 [B, H, L, D] tensors read by TMA through the 14
// geometry words each in `geo` (q, k, v, dout in that order; sm90.cuh).
// lse and delta: float32 [B, H, Lq], contiguous. dk, dv: bf16, written
// through (batch, head, row) element strides strides[0..2] and [3..5];
// bias (may be null): float32, strides[6..8] (0 where broadcast). D: 64,
// 128 or 256. Dropout as in pt_flash_attention_fwd. Returns the cudaError_t
// of the launch.
extern "C" int pt_flash_attention_bwd_dkv_sm90(
    const void* q, const void* k, const void* v, const void* bias,
    const void* dout, const void* lse, const void* delta, void* dk, void* dv,
    int B, int H, int Lq, int Lk, int D, const unsigned long long* geo,
    const long long* strides, int causal, float scale, int dropout_enabled,
    unsigned long long seed, unsigned int threshold, float drop_scale,
    void* stream) {
  DkvParams p;
  CUtensorMap maps[4];
  const cudaError_t err = make_bwd_params(
      p, maps, 2, q, k, v, bias, dout, lse, delta, dk, dv, B, H, Lq, Lk, geo,
      strides, causal, scale, dropout_enabled, seed, threshold, drop_scale);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = dropout_enabled != 0;
  if (D == 64)
    return (int)(drop ? launch<64, true>(maps, p, s)
                      : launch<64, false>(maps, p, s));
  if (D == 128)
    return (int)(drop ? launch<128, true>(maps, p, s)
                      : launch<128, false>(maps, p, s));
  if (D == 256)
    return (int)(drop ? launch<256, true>(maps, p, s)
                      : launch<256, false>(maps, p, s));
  return (int)cudaErrorInvalidValue;
}
