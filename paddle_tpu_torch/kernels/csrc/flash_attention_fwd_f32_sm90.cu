// Flash-attention forward for float32 inputs on Hopper tensor cores
// (sm_90a): both float32 operands of each product split into three bf16
// terms, wgmma fed by TMA, CUDA C++ with a plain C entry.
//
// Replaces: paddle_tpu/kernels/flash_attention.py `_fwd_kernel` (:131),
// launched by `_flash_fwd_impl` (:352, pallas_call at :383), with its
// in-kernel dropout (`_dropout_mask`, :120; here philox.cuh), for float32
// q/k/v at head dims 64, 128 and 256: the attention of every serving
// prefill (float32 parameters). float16 q/k/v take this kernel too (float16
// O2 training): the reference computes float16 inputs with float32 operands
// as well, so only the split's input and O's element type differ. bf16
// inputs take flash_attention_fwd_sm90.cu; the Python wrapper routes by
// (dtype, D, kernel).
//
// Computes what flash_attention_fwd.cu computes, per (b, h): S = Q K^T *
// scale (+ float32 bias), the top-left causal mask (masked scores -1e30, keys
// past Lk -inf), O = dropout(softmax(S)) V with the row sum l over the
// undropped probabilities, LSE = m + log(max(l, 1e-30)) as float32
// [B, H, Lq], O written through its strides in the inputs' type (float32,
// or float16 rounded once from the float32 result, as the reference's
// `o_ref.dtype` cast does).
//
// Numerics: the reference computes both products with float32 operands
// (`_operand_dtype`, :42-59, under full float32 matmul precision), so one
// bf16 or TF32 product would not do. Every float32 operand x enters as three
// bf16 terms, x0 = bf16(x), x1 = bf16(x - x0), x2 = bf16(x - x0 - x1)
// (sm90.cuh split_slice; |x - x0 - x1 - x2| <= 2^-24 |x|), and each product
// keeps the six term pairs with i + j <= 2:
//   S = Q0 K0 + Q1 K0 + Q2 K0 + Q0 K1 + Q1 K1 + Q0 K2   (^T on each K)
//   O += P0 V0 + P1 V0 + P2 V0 + P0 V1 + P1 V1 + P0 V2
// The dropped pairs are of order 2^-24 |a| |b|, float32's own rounding. Six
// bf16 wgmmas take the tensor cores as long as three TF32 ones (989 against
// 495 TFLOP/s), keep the bf16 TMA maps, descriptors and self-check of
// sm90.cuh, and need no transpose of V (TF32 wgmma reads B K-major only).
//
// Q, K and V are split once per call by split_terms_kernel below, which reads
// the strided float32 (or float16) views of the fused qkv and writes each
// operand's terms
// as one contiguous bf16 [3 B, H, L, D] tensor (term t of batch b at batch
// t B + b), so one TMA map per operand reaches all three terms. P is a
// float32 matrix the kernel makes in registers and is split there, 16
// columns at a time, into the A fragments of the P V wgmmas.
//
// float16. A float16 value has 11 significant bits and bf16 has float32's
// exponent range, so x = x0 + x1 exactly and the third term is zero: the
// split of a float16 operand is exact, and S is the float32 product of the
// float16 inputs. The split reads float16 directly (no float32 copy in
// between); the kernel is the float32 one with O stored as float16.
//
// Bound on an H100: at [1, 16, 2048, 128] causal, 12 bf16 products of
// 2 D FLOP per kept pair (6 for S, 6 for P V) are 1.03e11 FLOP: 0.104 ms at
// 989 TFLOP/s. The kernel moves about 67 MB (q, k, v, o in float32; 0.020 ms)
// and the split 125 MB (0.037 ms), so it is bound by operations.
//
// Shared memory, not registers, is the new constraint. One bf16 [64, D] tile
// is 16 KB at D = 128; Q's three terms stay resident (48 KB). Two-stage K and
// V rings of three-term tiles would add 192 KB, 240 KB in all, over the
// 227 KB a block may use. So one ring carries single term tiles in the order
// the products use them, K0 K1 K2 V0 V1 V2 for each key tile:
//   3 entries: 48 + 48 KB (+ 1 KB alignment) = 97 KB, two CTAs per SM
//              (2 x 98 KB of the SM's 228 KB);
//   4 entries: 112 KB + 72 bytes of barriers; with the usual 1 KB of
//              alignment slack two CTAs would need 230 KB, with 896 bytes
//              (FwdLayout) they fit in 228 KB;
//   6 entries (a whole key tile in flight): 145 KB, one CTA per SM.
// Two CTAs per SM keep the overlap PR 3 measured as the forward's main one:
// the two interleave, so one's softmax and barrier waits overlap the other's
// products. Four entries let the producer run three term tiles ahead; they
// measured 2 % faster than three (A/B in turns on an H100), and a consumer
// that held two entries at a time (its next group issued before the last
// one's wait) 14 % slower. At D = 64 (8 KB tiles) the ring holds a whole
// key tile: 24 + 48 KB. Registers: O (64 floats a thread at D = 128) and S
// (32) as in the bf16 kernel, then O and P's terms (48) in the P V phase,
// within the 168 that two CTAs of 160 threads leave.
//
// D = 256 keeps this shape at one CTA per SM: Q's three terms take 96 KB
// and four ring entries of 32 KB another 128 KB (225 KB with the barriers
// and the alignment slack), and the CTA gets up to 255 registers a thread.
// O is 128 floats a thread, so P's twelve fragments cannot all be live
// beside it: the P V phase waits for the key tile's three V terms at once
// and splits P one 16-column slice at a time, right before that slice's
// six m64n256k16 wgmmas (pv_by_slice). Bound at [1, 8, 1024, 256] causal:
// 12 bf16 products of 2 D FLOP per kept pair, 0.026 ms at 989 TFLOP/s,
// against 0.332 ms for the FMA kernel that took it before.
//
// Design otherwise as flash_attention_fwd_sm90.cu: one CTA per (b, h, 64-row
// query tile), query tiles walked from the last so the heaviest causal tiles
// start first; one consumer warpgroup that owns the 64 query rows and one
// producer warp; each ring entry with its own `full` and `empty` mbarrier,
// released as soon as the products of its term have completed; masks only
// on the diagonal and ragged tiles; dropout only in its own instantiation
// (code compiled in but skipped cost the bf16 kernel half its speed); rows
// past Lq and keys past Lk arrive as zeros from TMA; no atomics, so a run
// replays bit for bit, and dropout draws the per-element Philox bits every
// kernel draws (philox.cuh), so the FMA backward sees this kernel's mask.
// The two kernels share the softmax, the epilogue and the launch
// (flash_fwd_sm90.cuh, which says why they stay two kernels).
//
// The kernels allocate nothing and do not synchronise: the caller passes the
// term buffers, the outputs and PyTorch's current stream.

#include "philox.cuh"
#include "sm90.cuh"
#include "flash_fwd_sm90.cuh"

namespace {

using namespace pt_fwd_sm90;

constexpr int kLoadsPerKeyTile = 2 * kSplit;  // K0 K1 K2 V0 V1 V2

// ------------------------------------------------------------ the split
// One float32 or float16 (Src) [B, H, L, D] operand (element strides of
// batch, head, row; the last dim contiguous, rows aligned to 4 elements)
// and its bf16 terms, contiguous [3 B, H, L, D].
template <typename Src>
struct SplitOperand {
  const Src* src;
  __nv_bfloat16* dst;
  long long st[3];
  int L;
};

template <typename Src>
struct SplitParams {
  SplitOperand<Src> op[3];
  int B, H, D;
};

// Four consecutive values as float32: one 16-byte load of float32, one
// 8-byte load of float16 (converted exactly).
__device__ __forceinline__ float4 load4(const float* src) {
  return *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ float4 load4(const __half* src) {
  const uint2 w = *reinterpret_cast<const uint2*>(src);
  const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&w.x));
  const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&w.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// blockIdx.y picks the operand; each thread splits 4 values at a time: one
// load (load4), three 8-byte stores (one per term).
template <typename Src>
__global__ void __launch_bounds__(256)
split_terms_kernel(const SplitParams<Src> p) {
  const SplitOperand<Src> op = p.op[blockIdx.y];
  const int d4 = p.D / 4;
  const long long n4 = (long long)p.B * p.H * op.L * d4;
  const long long term = (long long)p.B * p.H * op.L * p.D;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % d4) * 4;
    const long long r = i / d4;  // (b * H + h) * L + row
    const int row = (int)(r % op.L);
    const int bh = (int)(r / op.L);
    const int h = bh % p.H, b = bh / p.H;
    float4 x =
        load4(op.src + b * op.st[0] + h * op.st[1] + row * op.st[2] + c);
    __nv_bfloat16* dst = op.dst + r * p.D + c;
#pragma unroll
    for (int t = 0; t < kSplit; ++t) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
      *reinterpret_cast<uint2*>(dst + t * term) =
          make_uint2(bf16x2_bits(lo), bf16x2_bits(hi));
      const float2 lf = __bfloat1622float2(lo), hf = __bfloat1622float2(hi);
      x.x -= lf.x;
      x.y -= lf.y;
      x.z -= hf.x;
      x.w -= hf.y;
    }
  }
}

// ------------------------------------------------------------ the kernel
template <int D>
struct FwdLayout {
  static constexpr uint32_t kTile = 64 * D * 2;  // bytes of one [64, D] tile
  static constexpr int kRing = D == 64 ? kLoadsPerKeyTile : 4;
  __host__ __device__ static constexpr uint32_t q(int term) {
    return kTile * term;
  }
  __host__ __device__ static constexpr uint32_t slot(int s) {
    return kTile * (kSplit + s);
  }
  static constexpr uint32_t bars = kTile * (kSplit + kRing);
  static constexpr uint32_t q_full = bars;
  __host__ __device__ static constexpr uint32_t full(int s) {
    return bars + 8 * (1 + s);
  }
  __host__ __device__ static constexpr uint32_t empty(int s) {
    return bars + 8 * (1 + kRing + s);
  }
  static constexpr uint32_t kUsed = bars + 8 * (1 + 2 * kRing);
  // The base is aligned up to the swizzle atom (1024 bytes). A CTA without
  // static shared memory gets a dynamic base that is already aligned, so
  // 896 bytes of slack, not 1024, are set aside for that: it is what lets
  // two CTAs of 4 ring entries share an SM at D = 128 (2 x (114760 + 896 +
  // 1024 reserved) of its 233472 bytes). The kernel traps if a base ever
  // needs more.
  static constexpr size_t kBytes = kUsed + 896;
};

// O += sum of P_a V_j over a + j <= 2 for key tile i at D = 256: O is 128
// floats a thread, so P's 48 fragment registers (four slices of three
// terms) beside it would spill. The three V term tiles of the key tile are
// waited for together (ring entries 6 i + 3 .. 6 i + 5, the ring holds
// four); then P is split one 16-column slice at a time, right before that
// slice's six m64n256k16 wgmmas, each slice a commit group of its own: the
// next slice is split while the last one's products run, and only two
// slices' terms (24 registers) are live.
__device__ __forceinline__ void pv_by_slice(float (&o)[128],
                                            const float (&sc)[32],
                                            uint32_t base, int i) {
  using L = FwdLayout<256>;
  uint32_t tv[kSplit];
#pragma unroll
  for (int j = 0; j < kSplit; ++j) {
    const int n = i * kLoadsPerKeyTile + kSplit + j;
    tv[j] = base + L::slot(n % L::kRing);
    asm volatile("" : "+r"(tv[j]));
    mbar_wait(base + L::full(n % L::kRing), (n / L::kRing) & 1);
  }
  __syncwarp();
  uint32_t f[2][kSplit][4];
  fence_operand(o);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    split_slice([&](int e) { return sc[e]; }, kk, f[kk & 1]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kSplit; ++j) {
      const uint64_t desc = mnmajor_desc(tv[j], kk);
#pragma unroll
      for (int a = 0; a + j < kSplit; ++a)
        wgmma_rs_n256_tb(o, f[kk & 1][a], desc, 1);
    }
    wgmma_commit();
    if (kk > 0) {
      wgmma_wait_pending<1>();
      fence_fragments(f[(kk - 1) & 1]);
    }
  }
  wgmma_wait_all();
  fence_fragments(f[1]);
  fence_operand(o);
#pragma unroll
  for (int j = 0; j < kSplit; ++j) {
    const int n = i * kLoadsPerKeyTile + kSplit + j;
    mbar_arrive(base + L::empty(n % L::kRing));
  }
}

// CTAs per SM: two at D 64/128 (168 registers a thread); one at D = 256,
// where Q's terms and the ring take 224 KB and O is 128 floats a thread.
template <int D>
constexpr int kCtasPerSm = D == 256 ? 1 : 2;

// kDropout: the dropout draws are compiled only into the instantiation that
// uses them. Out: O's element type, float (float32 inputs) or __half
// (float16 inputs).
template <int D, bool kDropout, typename Out>
__global__ void __launch_bounds__(kThreads, kCtasPerSm<D>)
flash_fwd_f32_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const FwdParams<Out> p) {
  using L = FwdLayout<D>;
  constexpr int kRing = L::kRing;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  if (base + L::kUsed > smem_u32(smem_raw) + L::kBytes) __trap();

  const FwdTile c = fwd_tile(p.Lk, p.causal);
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(base + L::q_full, 1);
    for (int s = 0; s < kRing; ++s) {
      mbar_init(base + L::full(s), 1);
      mbar_init(base + L::empty(s), kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warp: one lane issues every copy, the term tiles in the
    // order the consumers use them
    if (tid == kConsumers) {
      mbar_arrive_expect_tx(base + L::q_full, kSplit * L::kTile);
      for (int a = 0; a < kSplit; ++a)
        tma_load_tile<D>(base + L::q(a), &map_q, base + L::q_full, c.q0, c.h,
                         a * p.B + c.b, p.pos_q);
      for (int n = 0; n < c.n_kt * kLoadsPerKeyTile; ++n) {
        const int s = n % kRing;
        const int j = n % kLoadsPerKeyTile;  // K0 K1 K2 V0 V1 V2
        const bool is_k = j < kSplit;
        mbar_wait(base + L::empty(s), ((n / kRing) & 1) ^ 1);
        mbar_arrive_expect_tx(base + L::full(s), L::kTile);
        tma_load_tile<D>(base + L::slot(s), is_k ? &map_k : &map_v,
                         base + L::full(s), (n / kLoadsPerKeyTile) * 64, c.h,
                         (j % kSplit) * p.B + c.b, is_k ? p.pos_k : p.pos_v);
      }
    }
    return;
  }

  // ---- consumer warpgroup
  FwdRows rows(p, c, tid);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  float sc[32];
  float alpha0, alpha1;
  mbar_wait(base + L::q_full, 0);
  for (int i = 0; i < c.n_kt; ++i) {
    // Ring entry n = 6 i + j holds K term j (j < 3) or V term j - 3. The
    // tile addresses are made opaque once per key tile, so the compiler
    // builds each wgmma descriptor where it is used instead of hoisting all
    // of them (Q's three terms alone are 24) out of the loop.
    uint32_t tq = base + L::q(0);
    asm volatile("" : "+r"(tq));
    // ---- S = sum of Q_a K_j^T over a + j <= 2
#pragma unroll
    for (int j = 0; j < kSplit; ++j) {
      const int n = i * kLoadsPerKeyTile + j;
      const int s = n % kRing;
      uint32_t tk = base + L::slot(s);
      asm volatile("" : "+r"(tk));
      // D = 256: Q's descriptors (3 terms x 16 slices) would be kept from
      // one K term to the next; made anew per term they need no registers
      if constexpr (D == 256) asm volatile("" : "+r"(tq));
      mbar_wait(base + L::full(s), (n / kRing) & 1);
      __syncwarp();
      terms_abt<D, false>(sc, tq, tk, j, j == 0);
      mbar_arrive(base + L::empty(s));
    }
    rows.softmax<kDropout>(p, c, sc, i * 64, alpha0, alpha1);
    rescale<D>(o, alpha0, alpha1);
    // ---- O += sum of P_a V_j over a + j <= 2, P's terms made once
    if constexpr (D == 256) {
      pv_by_slice(o, sc, base, i);
    } else {
      uint32_t f[4][kSplit][4];
      split_all([&](int e) { return sc[e]; }, f);
#pragma unroll
      for (int j = 0; j < kSplit; ++j) {
        const int n = i * kLoadsPerKeyTile + kSplit + j;
        const int s = n % kRing;
        uint32_t tv = base + L::slot(s);
        asm volatile("" : "+r"(tv));
        mbar_wait(base + L::full(s), (n / kRing) & 1);
        __syncwarp();
        terms_fb<D, false>(o, f, tv, j);
        mbar_arrive(base + L::empty(s));
      }
    }
  }

  rows.store<D>(p, c, o);
}

template <int D, bool kDropout, typename Out>
cudaError_t launch(const CUtensorMap (&m)[3], const FwdParams<Out>& p,
                   cudaStream_t stream) {
  static unsigned smem_set = 0;
  return launch_fwd(flash_fwd_f32_sm90_kernel<D, kDropout, Out>,
                    FwdLayout<D>::kBytes, smem_set, m, p, stream);
}

template <typename Src>
int split_terms(int n_ops, const void* const* src, void* const* dst,
                const int* L, const long long* strides, int B, int H, int D,
                cudaStream_t stream) {
  SplitParams<Src> p;
  p.B = B;
  p.H = H;
  p.D = D;
  long long most = 0;
  for (int i = 0; i < n_ops; ++i) {
    p.op[i].src = static_cast<const Src*>(src[i]);
    p.op[i].dst = static_cast<__nv_bfloat16*>(dst[i]);
    for (int k = 0; k < 3; ++k) p.op[i].st[k] = strides[3 * i + k];
    p.op[i].L = L[i];
    const long long n4 = (long long)B * H * L[i] * (D / 4);
    most = n4 > most ? n4 : most;
  }
  if (most <= 0) return (int)cudaErrorInvalidValue;
  const long long want = (most + 255) / 256;
  const dim3 grid((unsigned)(want < 2048 ? want : 2048), n_ops);
  split_terms_kernel<Src><<<grid, 256, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename Out>
int run_fwd(const void* q3, const void* k3, const void* v3, const void* bias,
            void* o, void* lse, int B, int H, int Lq, int Lk, int D,
            const unsigned long long* geo, const long long* strides,
            int causal, float scale, int dropout_enabled,
            unsigned long long seed, unsigned int threshold, float drop_scale,
            cudaStream_t s) {
  FwdParams<Out> p;
  CUtensorMap m[3];
  const cudaError_t err = make_fwd_params(
      p, m, q3, k3, v3, bias, o, lse, B, H, Lq, Lk, geo, strides, causal,
      scale, dropout_enabled, seed, threshold, drop_scale);
  if (err != cudaSuccess) return (int)err;
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

// ------------------------------------------------------------ self-check
// One warpgroup, the two products of the kernel on float32 A, B of [64, D]
// given as their bf16 terms ([3, 1, 64, D], from split_terms_kernel):
//   c1 [64, 64] = A B^T        (terms_abt over the three B terms)
//   c2 [64, D]  = A[:, :64] B  (A's float32 fragments split in registers,
//                               terms_fb over the three B terms)
// through the same TMA loads of term tiles, descriptors and term pairs as
// the attention kernel. a: float32 [64, D], contiguous.
template <int D>
__global__ void __launch_bounds__(128, 1)
selfcheck_f32_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b, TmaPos pos_a,
                     TmaPos pos_b, const float* __restrict__ a,
                     float* __restrict__ c1, float* __restrict__ c2) {
  constexpr uint32_t kTile = 64 * D * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t tile_a = base, tile_b = base + kSplit * kTile;
  const uint32_t bar = base + 2 * kSplit * kTile;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(bar, 2 * kSplit * kTile);
    for (int term = 0; term < kSplit; ++term) {
      tma_load_tile<D>(tile_a + term * kTile, &map_a, bar, 0, 0, term, pos_a);
      tma_load_tile<D>(tile_b + term * kTile, &map_b, bar, 0, 0, term, pos_b);
    }
  }
  mbar_wait(bar, 0);

  const int w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const int r0 = 16 * w + g, r1 = r0 + 8;

  float d1[32];
#pragma unroll
  for (int j = 0; j < kSplit; ++j)
    terms_abt<D, false>(d1, tile_a, tile_b + j * kTile, j, j == 0);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      c1[(e < 2 ? r0 : r1) * 64 + 8 * j + 2 * t + (e & 1)] = d1[4 * j + e];

  // element i of A[:, :64] in the accumulator layout: row r0 or r1, column
  // 8 (i / 4) + 2 t + (i % 2)
  auto elem = [&](int i) {
    return a[((i & 2) ? r1 : r0) * D + 8 * (i / 4) + 2 * t + (i & 1)];
  };
  uint32_t f[4][kSplit][4];
  split_all(elem, f);
  float d2[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) d2[i] = 0.f;
#pragma unroll
  for (int j = 0; j < kSplit; ++j)
    terms_fb<D, false>(d2, f, tile_b + j * kTile, j);
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      c2[(e < 2 ? r0 : r1) * D + 8 * j + 2 * t + (e & 1)] = d2[4 * j + e];
}

template <int D>
cudaError_t launch_selfcheck(const void* a, const void* a3, const void* b3,
                             const unsigned long long* geo_a,
                             const unsigned long long* geo_b, float* c1,
                             float* c2, cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  TmaPos pos_a, pos_b;
  cudaError_t err = encode_tensor_map(&map_a, &pos_a, a3, geo_a);
  if (err == cudaSuccess) err = encode_tensor_map(&map_b, &pos_b, b3, geo_b);
  if (err != cudaSuccess) return err;
  auto kernel = selfcheck_f32_kernel<D>;
  constexpr size_t kSmem = 2 * kSplit * 64 * D * 2 + 8 + 1024;
  static unsigned smem_set = 0;
  err = allow_smem(kernel, kSmem, smem_set);
  if (err != cudaSuccess) return err;
  kernel<<<1, 128, kSmem, stream>>>(map_a, map_b, pos_a, pos_b,
                                    static_cast<const float*>(a), c1, c2);
  return cudaGetLastError();
}

}  // namespace

// Split n_ops (1 to 3) [B, H, L_i, D] operands of one type into bf16
// terms: dtype 0 for float32 (16-byte aligned rows), 2 for float16 (8-byte
// aligned rows); src[i] read through its (batch, head, row) element strides
// strides[3 i .. 3 i + 2] (last dim contiguous), dst[i] contiguous bf16
// [3 B, H, L_i, D], term t at batch t B + b. D a multiple of 4. Returns the
// launch's cudaError_t.
extern "C" int pt_split_bf16_terms(int n_ops, const void* const* src,
                                   void* const* dst, const int* L,
                                   const long long* strides, int B, int H,
                                   int D, int dtype, void* stream) {
  if (n_ops < 1 || n_ops > 3 || D % 4) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return split_terms<float>(n_ops, src, dst, L, strides, B, H, D, s);
  if (dtype == 2)
    return split_terms<__half>(n_ops, src, dst, L, strides, B, H, D, s);
  return (int)cudaErrorInvalidValue;
}

// q3, k3, v3: the bf16 terms of float32 (or float16) q, k, v as
// pt_split_bf16_terms writes them ([3 B, H, L, D]), read by TMA through the
// 14 geometry words each in `geo` (q3, then k3, then v3; see sm90.cuh). o:
// out_dtype 0 float32, 2 float16, written through its (batch, head, row)
// element strides, strides[0..2]; bias (may be null): float32 with
// strides[3..5] (0 where broadcast). lse: float32 [B, H, Lq], contiguous.
// D: 64, 128 or 256. Dropout as in pt_flash_attention_fwd. Returns the
// cudaError_t of the launch.
extern "C" int pt_flash_attention_fwd_f32_sm90(
    const void* q3, const void* k3, const void* v3, const void* bias, void* o,
    void* lse, int B, int H, int Lq, int Lk, int D,
    const unsigned long long* geo, const long long* strides, int causal,
    float scale, int dropout_enabled, unsigned long long seed,
    unsigned int threshold, float drop_scale, int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return run_fwd<float>(q3, k3, v3, bias, o, lse, B, H, Lq, Lk, D, geo,
                          strides, causal, scale, dropout_enabled, seed,
                          threshold, drop_scale, s);
  if (out_dtype == 2)
    return run_fwd<__half>(q3, k3, v3, bias, o, lse, B, H, Lq, Lk, D, geo,
                           strides, causal, scale, dropout_enabled, seed,
                           threshold, drop_scale, s);
  return (int)cudaErrorInvalidValue;
}

// The float32 self-check above for D = 64, 128 or 256: a float32 [64, D]
// contiguous; a3, b3 the bf16 terms of a and b ([3, 1, 64, D]) with their
// 14 tensor-map geometry words; c1 float32 [64, 64], c2 float32 [64, D].
// Returns the launch's cudaError_t.
extern "C" int pt_sm90_selfcheck_f32(const void* a, const void* a3,
                                     const void* b3,
                                     const unsigned long long* geo_a,
                                     const unsigned long long* geo_b,
                                     void* c1, void* c2, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* f1 = static_cast<float*>(c1);
  float* f2 = static_cast<float*>(c2);
  if (D == 64)
    return (int)launch_selfcheck<64>(a, a3, b3, geo_a, geo_b, f1, f2, s);
  if (D == 128)
    return (int)launch_selfcheck<128>(a, a3, b3, geo_a, geo_b, f1, f2, s);
  if (D == 256)
    return (int)launch_selfcheck<256>(a, a3, b3, geo_a, geo_b, f1, f2, s);
  return (int)cudaErrorInvalidValue;
}
