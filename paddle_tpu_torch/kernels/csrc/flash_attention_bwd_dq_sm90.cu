// Flash-attention backward, dQ (and dS), for bf16 inputs on Hopper tensor
// cores (sm_90a): wgmma fed by TMA, CUDA C++ with a plain C entry.
//
// Replaces: paddle_tpu/kernels/flash_attention.py `_bwd_dq_kernel` (:198,
// pallas_call at :466 in `_flash_bwd_impl`, :411), for bf16 q/k/v/dO at
// head dims 64 and 128. float32 inputs take flash_attention_bwd_f32_sm90.cu,
// D = 256 the FMA dQ kernel of flash_attention_bwd.cu; the Python wrapper
// routes by (dtype, D). The score-tile code is shared with the other
// Hopper backward kernels (flash_bwd_sm90.cuh).
//
// Computes what the FMA dQ kernel computes, per (b, h) and query tile: with
// P = exp(S * scale + bias - LSE) (0 above the top-left causal diagonal and
// past the ragged edge), M the dropout multiplier (philox.cuh; 1 without
// dropout) and Delta = rowsum(dO * O) from the caller,
//   dP = (dO V^T) * M,   dS = P * (dP - Delta),   dQ = dS K * scale,
// dQ written in bf16 through its strides and, when asked for, dS itself as
// float32 [B, H, Lq, Lk] (the bias gradient before its reduction), with the
// tiles the causal mask skips written as zeros (as the reference does at
// :259-262: the caller's buffer is uninitialised).
//
// Numerics: as in the other wgmma kernels, the reference's default float32
// operands (:42-59) are kept. S = Q K^T and dP = dO V^T are bf16 x bf16
// products, exact in the float32 accumulator; dS, a float32 matrix the
// kernel makes, enters dS K as three bf16 terms (sm90.cuh split_slice),
// which is the float32-operand product to 2^-24 of sum |ds k|, float32's
// own rounding.
//
// Bound on an H100: per kept (query, key) pair 6 D FLOP (Q K^T, dO V^T,
// dS K; 10 D on the tensor cores with the split) against about 42 MB of
// HBM traffic at the training shape [2, 16, 1024, 128] causal: 13 us of
// bf16 tensor-core work (22 us with the split) against 13 us of bytes, so
// it sits on the ridge. The FMA kernel took 0.80 ms on the CUDA cores.
//
// Design:
// - one CTA per (b, h, 64 query rows); the query tile is the slowest grid
//   dimension, walked from the last, so the heaviest causal tiles of every
//   (b, h) start first;
// - one consumer warpgroup, owning the 64 rows and their dQ accumulator
//   (D / 2 floats a thread), and a producer warp; two CTAs per SM (168
//   registers a thread), the forward's layout: one CTA's exponentials and
//   splits overlap the other's products. The dK/dV kernel's layout (two
//   consumer warpgroups, setmaxnreg 40/232) measured slower here and
//   spilled: ptxas gave its consumers no more than the 168 registers the
//   CTA launches with;
// - the producer loads the Q and dO tiles once, then streams K and V tiles
//   of 64 keys from key 0 up to the diagonal by TMA (128-byte swizzle)
//   through 2-stage rings, K and V each with their own `full` and `empty`
//   mbarriers: V is released once dP has read it, K once dS K has;
// - per key tile: the thread's 32 dropout keep bits (one register), drawn
//   while the tile is in flight; S = Q K^T (m64n64k16 wgmmas, both operands
//   K-major in shared memory) and P on its fragment; then dP = dO V^T the
//   same way and dS = P (dP M - Delta) in place of dP, stored as float32
//   when asked for; dQ += dS K with dS's three bf16 terms as register A
//   fragments, 16 columns at a time (m64nDk16, K the transposed B operand:
//   the tile that served S). At most dQ, S and dP (128 floats at D = 128)
//   are live, which fits the 168 registers without spills;
// - only the diagonal and ragged tiles take the mask tests, in their own
//   copy of the P loop (one loop with the tests skipped by a flag spilled
//   and was slower), and the dropout draws are compiled only into the
//   kernel instantiated with them;
// - rows past Lq and keys past Lk arrive as zeros from TMA; keys past Lk
//   get P = 0, and rows past Lq get dS = 0 and are not stored;
// - no atomics: every dQ and dS element has one writer, so a run replays
//   bit for bit. Dropout draws the same per-element Philox bits as the
//   forward and dK/dV kernels.
//
// The kernel allocates nothing and does not synchronise.

#include "philox.cuh"
#include "sm90.cuh"
#include "flash_bwd_sm90.cuh"

namespace {

using namespace pt_bwd_sm90;
using DqParams = BwdParams<__nv_bfloat16>;

constexpr int kStages = 2;
constexpr int kThreads = kConsumers + 32;  // one warpgroup and a producer warp

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
// uses them. That instantiation runs one CTA per SM: at two, its 168
// registers a thread spill.
template <int D, bool kDropout>
__global__ void __launch_bounds__(kThreads, kDropout ? 1 : 2)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do,
                         const DqParams p) {
  using L = DqLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;

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
  const uint32_t tile_q = base + L::q, tile_do = base + L::dout;
  const DqRows rows(p, b, h, q0, tid);

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
    // The tiles' addresses, made opaque to the compiler once per key tile:
    // otherwise it builds every wgmma descriptor of Q, dO and both ring
    // stages once, ahead of the loop, and holds them (about 100 registers,
    // which spill beside dQ, S and dP) instead of a few integer operations
    // where each is used.
    uint32_t tq = tile_q, tdo = tile_do, tk = base + L::k(s),
             tv = base + L::v(s);
    asm volatile("" : "+r"(tq), "+r"(tdo), "+r"(tk), "+r"(tv));

    // ---- S = Q K^T, then P
    mbar_wait(base + L::k_full(s), phase);
    __syncwarp();
    float sc[32], dp[32];
    wgmma_kmajor_product<D>(sc, tq, tk);
    rows.probabilities(p, sc, q0, k0);

    // ---- dP = dO V^T, after P: S and dP in flight together would hold 32
    // more registers while P is made, and measured slower
    mbar_wait(base + L::v_full(s), phase);
    __syncwarp();
    wgmma_kmajor_product<D>(dp, tdo, tv);
    mbar_arrive(base + L::v_empty(s));

    // ---- dS = P (dP M - Delta), in place of dP
    rows.grad_scores(sc, dp, keep, kDropout ? p.drop.scale : 1.f);
    if (rows.dsb != nullptr) rows.store_ds(dp, k0, p.Lq, p.Lk);

    // ---- dQ += dS K, dS as its three bf16 terms
    wgmma_split_product<D, true>(dq, [&](int e) { return dp[e]; }, tk);
    mbar_arrive(base + L::k_empty(s));
  }

  if (rows.dsb != nullptr && p.causal && n_kt * 64 < p.Lk)
    rows.zero_unseen_ds(q0, n_kt, p.Lq, p.Lk, tid);
  // ---- dQ * scale, bf16, through its strides
  store_rows<D>(p.out0 + b * p.out0_st[0] + h * p.out0_st[1], p.out0_st[2],
                rows.qi0, rows.qi1, p.Lq, rows.t, dq, p.scale);
}

template <int D, bool kDropout>
cudaError_t launch(const CUtensorMap (&maps)[4], const DqParams& p,
                   cudaStream_t stream) {
  static unsigned smem_set = 0;
  return launch_bwd(flash_bwd_dq_sm90_kernel<D, kDropout>, kThreads,
                    DqLayout<D>::kBytes, smem_set, maps, p, (p.Lq + 63) / 64,
                    stream);
}

}  // namespace

// q, k, v, dout: bf16 [B, H, L, D] tensors read by TMA through the 14
// geometry words each in `geo` (q, k, v, dout in that order; sm90.cuh).
// lse and delta: float32 [B, H, Lq], contiguous. dq: bf16, written through
// its (batch, head, row) element strides strides[0..2]; ds (may be null):
// float32 [B, H, Lq, Lk], contiguous; bias (may be null): float32,
// strides[3..5] (0 where broadcast). D: 64 or 128. Dropout as in
// pt_flash_attention_fwd. Returns the cudaError_t of the launch.
extern "C" int pt_flash_attention_bwd_dq_sm90(
    const void* q, const void* k, const void* v, const void* bias,
    const void* dout, const void* lse, const void* delta, void* dq, void* ds,
    int B, int H, int Lq, int Lk, int D, const unsigned long long* geo,
    const long long* strides, int causal, float scale, int dropout_enabled,
    unsigned long long seed, unsigned int threshold, float drop_scale,
    void* stream) {
  DqParams p;
  CUtensorMap maps[4];
  const cudaError_t err = make_bwd_params(
      p, maps, 1, q, k, v, bias, dout, lse, delta, dq, ds, B, H, Lq, Lk, geo,
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
  return (int)cudaErrorInvalidValue;
}
