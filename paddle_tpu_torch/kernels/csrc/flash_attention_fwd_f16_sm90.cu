// Flash-attention forward for float16 inputs on Hopper tensor cores
// (sm_90a): native float16 wgmma fed by TMA, CUDA C++ with a plain C entry.
//
// Replaces: paddle_tpu/kernels/flash_attention.py `_fwd_kernel` (:131),
// launched by `_flash_fwd_impl` (:352, pallas_call at :383), with its
// in-kernel dropout (`_dropout_mask`, :120; here philox.cuh), for float16
// q/k/v at head dims 64, 128 and 256: the attention forward (and its
// recompute) of float16 (O2) training and the prefill of a float16 model.
// bf16 inputs take flash_attention_fwd_sm90.cu, float32 inputs
// flash_attention_fwd_f32_sm90.cu; the Python wrapper routes by (dtype, D,
// kernel).
//
// Computes what the other forwards compute (flash_fwd_sm90.cuh), per
// (b, h): S = Q K^T * scale (+ float32 bias), the top-left causal mask
// (masked scores -1e30, keys past Lk -inf), O = dropout(softmax(S)) V with
// the row sum l over the undropped probabilities, LSE = m + log(max(l,
// 1e-30)) as float32 [B, H, Lq], O rounded once to float16, from float32,
// as it is written through its strides.
//
// Numerics. The reference takes both products with float32 operands
// (`_operand_dtype`, :42-59). A product of two float16 values has at most
// 22 significant bits, exact in the float32 accumulator of a
// wgmma ...f32.f16.f16, so S = Q K^T is one native product: the
// float32-operand product up to summation order. P is a float32 matrix
// the kernel makes, with P <= 1 (P M <= 1 / (1 - p) under dropout), so it
// enters P V as the float16 hi/lo pair of P M s (sm90.cuh, "float16 pair"):
// s = pm_scale(kept), a power of two that keeps P M s below 2^15 (2^14
// without dropout), two native products against V, and 1 / s folded into
// the final 1 / l. The pair is within 2^-22 of each element of P M (2^-25 /
// s absolute among float16's subnormals), against float32's own 2^-24.
// Three native products per kept pair in all, where the wgmma_f32 forward
// ran twelve bf16 ones on the split pre-pass's terms.
//
// Bound on an H100 at [2, 16, 1024, 128] causal (16.79 M kept pairs): the
// kernel's 3 float16 products of 2 D FLOP a pair take 0.0130 ms at 989
// TFLOP/s; the least work, one product each for S and P V, 0.0087 ms; its
// bytes (q, k, v read once, O and LSE written once, 33.7 MB) 0.0101 ms at
// 3.35 TB/s. So it sits on the ridge, as the bf16 forward does.
//
// Design, the bf16 forward's (flash_attention_fwd_sm90.cu), whose rings,
// producer, softmax, epilogue and launch it shares (flash_fwd_sm90.cuh):
// - one CTA per (b, h, 64-row query tile), the query tile the slowest grid
//   dimension, walked from the last, so the heaviest causal tiles start
//   first; 160 threads: one consumer warpgroup (warps 0-3) that owns the 64
//   query rows and one producer warp (warp 4);
// - the producer loads Q once and streams K and V tiles of 64 keys into
//   2-stage rings by TMA (float16 tensor maps, 128-byte swizzle), each with
//   its own `full` and `empty` mbarriers; the consumers release a K tile
//   once S has read it and a V tile once P V has;
// - S = Q K^T: D / 16 float16 wgmma m64n64k16, both operands in shared
//   memory; scale, bias, masks, dropout and the online softmax on the
//   accumulator fragment; P never leaves registers: the hi/lo pair of each
//   16-column slice of P M s is the A fragment of two m64nDk16 float16
//   wgmmas against the transposed V tile (m64n256k16 at D = 256), all four
//   slices issued as one group and waited for once;
// - two CTAs per SM at D 64 and 128 (168 registers a thread), one at
//   D = 256 (O is 128 floats a thread), as in the bf16 kernel; the pair's
//   fragments (32 registers) are fewer than the bf16 kernel's three terms
//   of P (48);
// - masks only on the diagonal and ragged tiles; dropout only in its own
//   instantiation, drawing the per-element Philox bits every kernel draws
//   (philox.cuh), so the backward kernels see this kernel's mask; rows past
//   Lq and keys past Lk arrive as zeros from TMA, keys past Lk get
//   probability 0; no atomics, so a run replays bit for bit.
//
// The kernel allocates nothing and does not synchronise: the caller passes
// outputs and PyTorch's current stream.

#include "philox.cuh"
#include "sm90.cuh"
#include "flash_fwd_sm90.cuh"

namespace {

using namespace pt_fwd_sm90;
using Params = FwdParams<__half>;

// CTAs per SM: two at D 64/128, one at D = 256 (the bf16 forward's).
template <int D>
constexpr int kCtasPerSm = D == 256 ? 1 : 2;

// kDropout: the dropout draws are compiled only into the instantiation that
// uses them.
template <int D, bool kDropout>
__global__ void __launch_bounds__(kThreads, kCtasPerSm<D>)
flash_fwd_f16_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const Params p) {
  using L = RingLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;

  const FwdTile c = fwd_tile(p.Lk, p.causal);
  const int tid = threadIdx.x;

  if (tid == 0) init_rings<D>(base);
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warp: one lane issues every copy
    if (tid == kConsumers)
      produce_rings<D>(base, &map_q, &map_k, &map_v, c, p);
    return;
  }

  // ---- consumer warpgroup
  FwdRows rows(p, c, tid);
  // s: P M s < 2^15 for the float16 pair (pm_scale(1) = 2^14)
  const float pm = kDropout ? pm_scale(p.drop.scale) : 16384.f;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  // One key tile at a time: S = Q K^T, softmax, O += P V (the two CTAs an
  // SM holds at D 64/128 interleave, so one's softmax overlaps the other's
  // products).
  float sc[32];
  float alpha0, alpha1;
  mbar_wait(base + L::q_full, 0);
  for (int i = 0; i < c.n_kt; ++i) {
    const int s = i % kStages;
    const uint32_t phase = (i / kStages) & 1;
    mbar_wait(base + L::k_full(s), phase);
    __syncwarp();
    wgmma_kmajor_product<D, __half>(sc, base + L::q, base + L::k(s));
    mbar_arrive(base + L::k_empty(s));
    rows.softmax<kDropout>(p, c, sc, i * 64, alpha0, alpha1);
    rescale<D>(o, alpha0, alpha1);
    // ---- O += P V s: P M s (dropout applied in softmax) as its float16
    // hi/lo pair; s is a power of two, so the scaling is exact
    mbar_wait(base + L::v_full(s), phase);
    __syncwarp();
    wgmma_f16_pair_product<D, false>(o, [&](int e) { return sc[e] * pm; },
                                     base + L::v(s));
    mbar_arrive(base + L::v_empty(s));
  }
  // O = acc / (s l), rounded once to float16
  rows.store<D>(p, c, o, 1.f / pm);
}

template <int D, bool kDropout>
cudaError_t launch(const CUtensorMap (&m)[3], const Params& p,
                   cudaStream_t stream) {
  static unsigned smem_set = 0;
  return launch_fwd(flash_fwd_f16_sm90_kernel<D, kDropout>,
                    RingLayout<D>::kBytes, smem_set, m, p, stream);
}

}  // namespace

// q, k, v: float16 [B, H, L, D] tensors read by TMA through the 14
// geometry words each in `geo` (q, then k, then v; see sm90.cuh). o:
// float16, written through its (batch, head, row) element strides,
// strides[0..2]; bias (may be null): float32 with strides[3..5] (0 where
// broadcast). lse: float32 [B, H, Lq], contiguous. D: 64, 128 or 256.
// Dropout as in pt_flash_attention_fwd. Returns the cudaError_t of the
// launch.
extern "C" int pt_flash_attention_fwd_f16_sm90(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    void* lse, int B, int H, int Lq, int Lk, int D,
    const unsigned long long* geo, const long long* strides, int causal,
    float scale, int dropout_enabled, unsigned long long seed,
    unsigned int threshold, float drop_scale, void* stream) {
  Params p;
  CUtensorMap m[3];
  const cudaError_t err = make_fwd_params(
      p, m, q, k, v, bias, o, lse, B, H, Lq, Lk, geo, strides, causal, scale,
      dropout_enabled, seed, threshold, drop_scale,
      CU_TENSOR_MAP_DATA_TYPE_FLOAT16);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = dropout_enabled != 0;
  if (D == 64)
    return (int)(drop ? launch<64, true>(m, p, s) : launch<64, false>(m, p, s));
  if (D == 128)
    return (int)(drop ? launch<128, true>(m, p, s)
                      : launch<128, false>(m, p, s));
  if (D == 256)
    return (int)(drop ? launch<256, true>(m, p, s)
                      : launch<256, false>(m, p, s));
  return (int)cudaErrorInvalidValue;
}
