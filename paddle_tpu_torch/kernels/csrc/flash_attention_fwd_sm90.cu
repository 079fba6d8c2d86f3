// Flash-attention forward for bf16 inputs on Hopper tensor cores (sm_90a):
// wgmma fed by TMA, CUDA C++ with a plain C entry.
//
// Replaces: paddle_tpu/kernels/flash_attention.py `_fwd_kernel` (:131),
// launched by `_flash_fwd_impl` (:352, pallas_call at :383), with its
// in-kernel dropout (`_dropout_mask`, :120; here philox.cuh), for bf16
// q/k/v at head dims 64, 128 and 256. float32 inputs take
// flash_attention_fwd_f32_sm90.cu (D 64/128) or the FMA kernel of
// flash_attention_fwd.cu (D = 256); the Python wrapper routes by (dtype, D,
// kernel).
//
// Computes what flash_attention_fwd.cu computes, per (b, h): S = Q K^T *
// scale (+ float32 bias), the top-left causal mask (masked scores -1e30, keys
// past Lk -inf), O = dropout(softmax(S)) V with the row sum l over the
// undropped probabilities, LSE = m + log(max(l, 1e-30)) as float32
// [B, H, Lq], O written in bf16 through its strides.
//
// Numerics: the reference's default `_operand_dtype` (:42-59) computes both
// products with float32 operands, also for bf16 inputs. Q K^T of bf16
// values is exact in wgmma's float32 accumulator, so S equals the float32
// product up to summation order. P is a float32 matrix the kernel made; a
// bf16 P would be the reference's PT_FLASH_BF16=1 mode, not its default. So
// P V is taken as P0 V + P1 V + P2 V with P0 = bf16(P), P1 = bf16(P - P0),
// P2 = bf16(P - P0 - P1) (sm90.cuh split_slice): three bf16 wgmmas
// against the same V tile, off the float32-operand product by at most
// 2^-24 sum |p v|, float32's own rounding.
//
// Bound on an H100: at the training shape [2, 16, 1024, 128] causal the
// kernel reads and writes about 34 MB and does 4 D FLOP per kept pair (with
// the split, 8 D on the tensor cores): about 10 us of HBM traffic against
// 9 us (17 us with the split) of bf16 tensor-core work, so it sits on the
// ridge; the FMA kernel ran the same work on the CUDA cores at 0.45 ms.
//
// Design:
// - one CTA per (b, h, 64-row query tile); the tile index is the slowest
//   grid dimension, walked from the last, so the heaviest causal tiles of
//   every (b, h) start first (1.35 times faster at the training shape than
//   walking each (b, h) in turn); 160 threads: one consumer warpgroup
//   (warps 0-3) that owns the 64 query rows, and one producer warp (warp 4);
// - the producer loads Q once and streams K and V tiles of 64 keys into
//   2-stage rings by TMA (128-byte swizzle), K and V each with their own
//   `full` and `empty` mbarriers: the consumers release a K tile as soon as
//   S = Q K^T has read it and a V tile once P V has;
// - S = Q K^T: D / 16 wgmma m64n64k16 with both operands in shared memory;
//   scale, bias, masks, dropout and the online softmax run on the
//   accumulator fragment, each row's max and sum over the 4 lanes that hold
//   it; P never leaves registers: its three bf16 terms are the A fragments
//   of the P V wgmmas (m64nDk16, V as the transposed B operand);
// - two CTAs per SM (168 registers a thread, 81 KB of shared memory at
//   D = 128), so one CTA's softmax overlaps the other's products;
// - D = 256: O is 128 floats a thread and P V one m64n256k16 wgmma per
//   slice and term (V's four 64-column atoms, sm90.cuh); K and V tiles are
//   32 KB, so the CTA keeps the same shape at one CTA per SM (160 KB, up to
//   255 registers: 238, 253 with dropout). Two CTAs per SM, with one-stage
//   rings, or two consumer warpgroups per CTA (128 query rows, or 64 rows
//   and a 128-column half of O each) measured 1.07-3.0 times slower at
//   [1, 8, 1024, 256] and [2, 16, 1024, 256] causal; the first two spill,
//   as this toolkit's ptxas gives a CTA of 288 threads, or two of 160, no
//   more than 168 registers a thread (PERF.md, section 6);
// - the masks run only on the diagonal and ragged tiles, and the dropout
//   draws only in the kernel instantiated with them;
// - rows past Lq and keys past Lk arrive as zeros from TMA (the ragged edge),
//   and keys past Lk get probability 0;
// - no atomics: each output element has one writer, so a run replays bit
//   for bit. Dropout draws the same per-element Philox bits as every other
//   kernel (philox.cuh), so the FMA dQ kernel sees this kernel's mask.
//
// The softmax, the epilogue and the launch are shared with the float32
// forward (flash_fwd_sm90.cuh).
//
// The kernel allocates nothing and does not synchronise: the caller passes
// outputs and PyTorch's current stream.

#define PT_SM90_SELFCHECK
#include "philox.cuh"
#include "sm90.cuh"
#include "flash_fwd_sm90.cuh"

namespace {

using namespace pt_fwd_sm90;
using Params = FwdParams<__nv_bfloat16>;

constexpr int kStages = 2;

template <int D>
struct FwdLayout {
  static constexpr uint32_t kTile = 64 * D * 2;  // bytes of one [64, D] tile
  static constexpr uint32_t q = 0;
  __host__ __device__ static constexpr uint32_t k(int s) {
    return kTile * (1 + s);
  }
  __host__ __device__ static constexpr uint32_t v(int s) {
    return kTile * (1 + kStages + s);
  }
  static constexpr uint32_t bars = kTile * (1 + 2 * kStages);
  static constexpr uint32_t q_full = bars;
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

// CTAs per SM: two at D 64/128, where the register budget that leaves (168)
// holds without spills; one at D = 256.
template <int D>
constexpr int kCtasPerSm = D == 256 ? 1 : 2;

// kDropout: the dropout draws are compiled only into the instantiation that
// uses them (present but skipped, they cost the other one half its speed).
template <int D, bool kDropout>
__global__ void __launch_bounds__(kThreads, kCtasPerSm<D>)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const Params p) {
  using L = FwdLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;

  const FwdTile c = fwd_tile(p.Lk, p.causal);
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(base + L::q_full, 1);
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
    // ---- producer warp: one lane issues every copy
    if (tid == kConsumers) {
      mbar_arrive_expect_tx(base + L::q_full, L::kTile);
      tma_load_tile<D>(base + L::q, &map_q, base + L::q_full, c.q0, c.h, c.b,
                       p.pos_q);
      for (int i = 0; i < c.n_kt; ++i) {
        const int s = i % kStages;
        const uint32_t free_phase = ((i / kStages) & 1) ^ 1;
        mbar_wait(base + L::k_empty(s), free_phase);
        mbar_arrive_expect_tx(base + L::k_full(s), L::kTile);
        tma_load_tile<D>(base + L::k(s), &map_k, base + L::k_full(s), i * 64,
                         c.h, c.b, p.pos_k);
        mbar_wait(base + L::v_empty(s), free_phase);
        mbar_arrive_expect_tx(base + L::v_full(s), L::kTile);
        tma_load_tile<D>(base + L::v(s), &map_v, base + L::v_full(s), i * 64,
                         c.h, c.b, p.pos_v);
      }
    }
    return;
  }

  // ---- consumer warpgroup
  FwdRows rows(p, c, tid);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  // One key tile at a time: S = Q K^T, softmax, O += P V. The two CTAs an
  // SM holds at D 64/128 (168 registers a thread) interleave, so one's
  // softmax overlaps the other's products. (Overlapping S_{i+1} with the
  // softmax inside one warpgroup needs 230 registers, one CTA per SM, and
  // measured 1.5 times slower.)
  float sc[32];
  float alpha0, alpha1;
  mbar_wait(base + L::q_full, 0);
  for (int i = 0; i < c.n_kt; ++i) {
    const int s = i % kStages;
    const uint32_t phase = (i / kStages) & 1;
    mbar_wait(base + L::k_full(s), phase);
    __syncwarp();
    wgmma_kmajor_product<D>(sc, base + L::q, base + L::k(s));
    mbar_arrive(base + L::k_empty(s));
    rows.softmax<kDropout>(p, c, sc, i * 64, alpha0, alpha1);
    rescale<D>(o, alpha0, alpha1);
    // ---- O += P V, P as its three bf16 terms
    mbar_wait(base + L::v_full(s), phase);
    __syncwarp();
    wgmma_split_product<D, false>(o, [&](int e) { return sc[e]; },
                                  base + L::v(s));
    mbar_arrive(base + L::v_empty(s));
  }
  rows.store<D>(p, c, o);
}

template <int D, bool kDropout>
cudaError_t launch(const CUtensorMap (&m)[3], const Params& p,
                   cudaStream_t stream) {
  static unsigned smem_set = 0;
  return launch_fwd(flash_fwd_sm90_kernel<D, kDropout>, FwdLayout<D>::kBytes,
                    smem_set, m, p, stream);
}

}  // namespace

// q, k, v: bf16 [B, H, L, D] tensors read by TMA through the 14 geometry
// words each in `geo` (q, then k, then v; see sm90.cuh). o: bf16, written
// through its (batch, head, row) element strides, strides[0..2]; bias (may
// be null): float32 with strides[3..5] (0 where broadcast). lse: float32
// [B, H, Lq], contiguous. D: 64, 128 or 256. Dropout as in
// pt_flash_attention_fwd. Returns the cudaError_t of the launch.
extern "C" int pt_flash_attention_fwd_sm90(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    void* lse, int B, int H, int Lq, int Lk, int D,
    const unsigned long long* geo, const long long* strides, int causal,
    float scale, int dropout_enabled, unsigned long long seed,
    unsigned int threshold, float drop_scale, void* stream) {
  Params p;
  CUtensorMap m[3];
  const cudaError_t err = make_fwd_params(
      p, m, q, k, v, bias, o, lse, B, H, Lq, Lk, geo, strides, causal, scale,
      dropout_enabled, seed, threshold, drop_scale);
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
