// Flash-attention forward for bf16 inputs on Hopper tensor cores (sm_90a):
// wgmma fed by TMA, CUDA C++ with a plain C entry.
//
// Replaces: paddle_tpu/kernels/flash_attention.py `_fwd_kernel` (:131),
// launched by `_flash_fwd_impl` (:352, pallas_call at :383), with its
// in-kernel dropout (`_dropout_mask`, :120; here philox.cuh), for bf16
// q/k/v at head dims 64 and 128. float32 inputs and D = 256 keep the FMA
// kernel of flash_attention_fwd.cu; the Python wrapper routes by (dtype, D).
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
// - the masks run only on the diagonal and ragged tiles, and the dropout
//   draws only in the kernel instantiated with them;
// - rows past Lq and keys past Lk arrive as zeros from TMA (the ragged edge),
//   and keys past Lk get probability 0;
// - no atomics: each output element has one writer, so a run replays bit
//   for bit. Dropout draws the same per-element Philox bits as every other
//   kernel (philox.cuh), so the FMA dQ kernel sees this kernel's mask.
//
// The kernel allocates nothing and does not synchronise: the caller passes
// outputs and PyTorch's current stream.

#define PT_SM90_SELFCHECK
#include "philox.cuh"
#include "sm90.cuh"

namespace {

using namespace pt_sm90;

constexpr int kStages = 2;
constexpr int kConsumers = 128;  // one warpgroup
constexpr int kThreads = kConsumers + 32;
constexpr float kMaskValue = -1e30f;  // the TPU kernels' _NEG_INF

struct FwdParams {
  __nv_bfloat16* o;
  float* lse;
  const float* bias;
  long long o_st[3], bias_st[3];  // element strides of (batch, head, row)
  int H, Lq, Lk, causal;
  float scale;
  DropoutParams drop;
  TmaPos pos_q, pos_k, pos_v;
};

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

// kDropout: the dropout draws are compiled only into the instantiation that
// uses them (present but skipped, they cost the other one half its speed).
// Two CTAs per SM: the register budget that leaves (168) holds without
// spills.
template <int D, bool kDropout>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const FwdParams p) {
  using L = FwdLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;

  // The query tile is the slowest grid dimension, walked from the last:
  // the heaviest causal tiles of every (b, h) start first.
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int q0 = qt * 64;
  // causal: keys past the tile's last query row are masked for every row
  const int k_end = p.causal ? min(p.Lk, q0 + 64) : p.Lk;
  const int n_kt = (k_end + 63) / 64;
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
      tma_load_tile<D>(base + L::q, &map_q, base + L::q_full, q0, h, b,
                       p.pos_q);
      for (int i = 0; i < n_kt; ++i) {
        const int s = i % kStages;
        const uint32_t free_phase = ((i / kStages) & 1) ^ 1;
        mbar_wait(base + L::k_empty(s), free_phase);
        mbar_arrive_expect_tx(base + L::k_full(s), L::kTile);
        tma_load_tile<D>(base + L::k(s), &map_k, base + L::k_full(s), i * 64,
                         h, b, p.pos_k);
        mbar_wait(base + L::v_empty(s), free_phase);
        mbar_arrive_expect_tx(base + L::v_full(s), L::kTile);
        tma_load_tile<D>(base + L::v(s), &map_v, base + L::v_full(s), i * 64,
                         h, b, p.pos_v);
      }
    }
    return;
  }

  // ---- consumer warpgroup
  const int w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const int qi0 = q0 + 16 * w + g;  // this thread's two query rows
  const int qi1 = qi0 + 8;
  const float* bias0 = nullptr;
  const float* bias1 = nullptr;
  if (p.bias != nullptr) {
    const float* bb = p.bias + b * p.bias_st[0] + h * p.bias_st[1];
    bias0 = bb + (long long)min(qi0, p.Lq - 1) * p.bias_st[2];
    bias1 = bb + (long long)min(qi1, p.Lq - 1) * p.bias_st[2];
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = kMaskValue, m1 = kMaskValue, l0 = 0.f, l1 = 0.f;

  // Scale, bias, masks, dropout and the online-softmax statistics of the
  // score tile `x` of keys k0 .. k0 + 63, in place (x becomes P); returns
  // the factors exp(m_old - m_new) by which O must be rescaled.
  auto softmax = [&](float (&x)[32], int k0, float& alpha0, float& alpha1) {
    // Only the diagonal tile and the ragged last tile need the masks: the
    // test is uniform over the CTA, so the other tiles skip them.
    const bool edge = k0 + 64 > p.Lk || (p.causal && k0 + 63 > q0);
    if (edge) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = e < 2 ? qi0 : qi1;
          const int kj = k0 + 8 * j + 2 * t + (e & 1);
          float v = x[4 * j + e] * p.scale;
          if (kj >= p.Lk) {
            v = -INFINITY;  // ragged edge: probability exactly 0
          } else {
            if (bias0 != nullptr && qi < p.Lq)
              v += (e < 2 ? bias0 : bias1)[kj];
            if (p.causal && qi < kj) v = kMaskValue;
          }
          x[4 * j + e] = v;
        }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = x[4 * j + e] * p.scale;
          if (bias0 != nullptr && (e < 2 ? qi0 : qi1) < p.Lq)
            v += (e < 2 ? bias0 : bias1)[k0 + 8 * j + 2 * t + (e & 1)];
          x[4 * j + e] = v;
        }
    }
    // row maxima over the 4 lanes that hold a row
    float mx0 = kMaskValue, mx1 = kMaskValue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(x[4 * j], x[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(x[4 * j + 2], x[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    alpha0 = expf(m0 - mn0);
    alpha1 = expf(m1 - mn1);
    // P = exp(S - m); l takes the undropped probabilities
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = expf(x[4 * j + e] - (e < 2 ? mn0 : mn1));
        if (e < 2)
          ps0 += pr;
        else
          ps1 += pr;
        x[4 * j + e] = pr;
      }
    if constexpr (kDropout) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = e < 2 ? qi0 : qi1;
          const int kj = k0 + 8 * j + 2 * t + (e & 1);
          if (qi < p.Lq && kj < p.Lk)
            x[4 * j + e] *= dropout_multiplier(p.drop, b, h, qi, kj);
        }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, off);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, off);
    }
    l0 = alpha0 * l0 + ps0;
    l1 = alpha1 * l1 + ps1;
    m0 = mn0;
    m1 = mn1;
  };

  auto rescale = [&](float alpha0, float alpha1) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= alpha0;
      o[4 * j + 1] *= alpha0;
      o[4 * j + 2] *= alpha1;
      o[4 * j + 3] *= alpha1;
    }
  };

  // One key tile at a time: S = Q K^T, softmax, O += P V. The two CTAs an
  // SM holds (168 registers a thread) interleave, so one's softmax overlaps
  // the other's products. (Overlapping S_{i+1} with the softmax inside one
  // warpgroup needs 230 registers, one CTA per SM, and measured 1.5 times
  // slower.)
  float sc[32];
  float alpha0, alpha1;
  mbar_wait(base + L::q_full, 0);
  for (int i = 0; i < n_kt; ++i) {
    const int s = i % kStages;
    const uint32_t phase = (i / kStages) & 1;
    mbar_wait(base + L::k_full(s), phase);
    __syncwarp();
    wgmma_kmajor_product<D>(sc, base + L::q, base + L::k(s));
    mbar_arrive(base + L::k_empty(s));
    softmax(sc, i * 64, alpha0, alpha1);
    rescale(alpha0, alpha1);
    // ---- O += P V, P as its three bf16 terms
    mbar_wait(base + L::v_full(s), phase);
    __syncwarp();
    wgmma_split_product<D, false>(o, [&](int e) { return sc[e]; },
                                  base + L::v(s));
    mbar_arrive(base + L::v_empty(s));
  }

  // ---- epilogue: O = acc / l, LSE = m + log(l)
  const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
  const float inv0 = 1.f / lc0, inv1 = 1.f / lc1;
  __nv_bfloat16* ob = p.o + b * p.o_st[0] + h * p.o_st[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r == 0 ? qi0 : qi1;
    if (qi >= p.Lq) continue;
    const float inv = r == 0 ? inv0 : inv1;
    __nv_bfloat16* orow = ob + (long long)qi * p.o_st[2];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                o[4 * j + 2 * r + 1] * inv);
    if (t == 0)
      p.lse[((long long)b * p.H + h) * p.Lq + qi] =
          (r == 0 ? m0 : m1) + logf(r == 0 ? lc0 : lc1);
  }
}

template <int D, bool kDropout>
cudaError_t launch(const CUtensorMap& mq, const CUtensorMap& mk,
                   const CUtensorMap& mv, const FwdParams& p, int B,
                   cudaStream_t stream) {
  auto kernel = flash_fwd_sm90_kernel<D, kDropout>;
  static unsigned smem_set = 0;
  cudaError_t err = allow_smem(kernel, FwdLayout<D>::kBytes, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, B, (p.Lq + 63) / 64);
  kernel<<<grid, kThreads, FwdLayout<D>::kBytes, stream>>>(mq, mk, mv, p);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: bf16 [B, H, L, D] tensors read by TMA through the 14 geometry
// words each in `geo` (q, then k, then v; see sm90.cuh). o: bf16, written
// through its (batch, head, row) element strides, strides[0..2]; bias (may
// be null): float32 with strides[3..5] (0 where broadcast). lse: float32
// [B, H, Lq], contiguous. D: 64 or 128. Dropout as in
// pt_flash_attention_fwd. Returns the cudaError_t of the launch.
extern "C" int pt_flash_attention_fwd_sm90(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    void* lse, int B, int H, int Lq, int Lk, int D,
    const unsigned long long* geo, const long long* strides, int causal,
    float scale, int dropout_enabled, unsigned long long seed,
    unsigned int threshold, float drop_scale, void* stream) {
  FwdParams p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.bias = static_cast<const float*>(bias);
  for (int i = 0; i < 3; ++i) {
    p.o_st[i] = strides[i];
    p.bias_st[i] = strides[3 + i];
  }
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.causal = causal;
  p.scale = scale;
  p.drop = DropoutParams{seed, threshold, drop_scale, dropout_enabled};
  CUtensorMap mq, mk, mv;
  cudaError_t err = encode_tensor_map(&mq, &p.pos_q, q, geo);
  if (err == cudaSuccess)
    err = encode_tensor_map(&mk, &p.pos_k, k, geo + kGeoWords);
  if (err == cudaSuccess)
    err = encode_tensor_map(&mv, &p.pos_v, v, geo + 2 * kGeoWords);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = dropout_enabled != 0;
  if (D == 64)
    return (int)(drop ? launch<64, true>(mq, mk, mv, p, B, s)
                      : launch<64, false>(mq, mk, mv, p, B, s));
  if (D == 128)
    return (int)(drop ? launch<128, true>(mq, mk, mv, p, B, s)
                      : launch<128, false>(mq, mk, mv, p, B, s));
  return (int)cudaErrorInvalidValue;
}
