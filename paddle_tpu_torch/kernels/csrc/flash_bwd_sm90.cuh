// The parts the Hopper flash-attention backward kernels share:
// flash_attention_bwd_dq_sm90.cu and flash_attention_bwd_dkv_sm90.cu (bf16
// operands) and flash_attention_bwd_f32_sm90.cu (float32 operands as three
// bf16 terms). They differ in how they feed the tensor cores; what they do
// on a score tile is here: the parameters and their host-side set-up, each
// consumer thread's rows, dropout keep bits, the probabilities P with their
// masks, the score gradient dS, the float32 dS output of the dQ kernels and
// the epilogue.
//
// With P = exp(S * scale + bias - LSE) (0 above the top-left causal diagonal
// and past the ragged edge), M the dropout multiplier (philox.cuh; 1 without
// dropout) and Delta = rowsum(dO * O) from the caller:
//   dP = (dO V^T) * M,   dS = P * (dP - Delta),
//   dQ = dS K * scale,   dK = dS^T Q * scale,   dV = (P * M)^T dO.
// The dQ kernels hold a 64 x 64 tile in the wgmma accumulator layout
// (sm90.cuh) with query rows, the dK/dV kernels its transpose, with key
// rows: DqRows and DkvRows are the two views.
//
// Masks run only on the diagonal and ragged tiles (a mask-free copy of the
// loop for the others measured 1.6 times faster on the bf16 dQ), and the
// dropout draws only in the instantiation compiled with them.

#pragma once

#include "philox.cuh"
#include "sm90.cuh"

namespace pt_bwd_sm90 {

using namespace pt_sm90;

constexpr int kConsumers = 128;  // threads of one consumer warpgroup

// Out: the element type of the gradients (__nv_bfloat16 or float).
template <typename Out>
struct BwdParams {
  Out *out0, *out1;  // dQ and (unused) in a dQ kernel; dK and dV in dK/dV
  float* ds;         // dQ kernels: float32 dS [B, H, Lq, Lk], or null
  const float *bias, *lse, *delta;
  long long out0_st[3], out1_st[3], bias_st[3];  // (batch, head, row)
  int B, H, Lq, Lk, causal;
  float scale;
  DropoutParams drop;
  TmaPos pos_q, pos_k, pos_v, pos_do;
};

// The C entries' arguments as kernel parameters and the four tensor maps
// (q, k, v, dout; 14 geometry words each in `geo`). `n_out` gradients
// (1 for dQ, 2 for dK and dV) take strides[0..2] and [3..5]; the bias the
// next three. `out1` is dS for a dQ kernel, dV for a dK/dV kernel.
template <typename Out>
inline cudaError_t make_bwd_params(
    BwdParams<Out>& p, CUtensorMap (&maps)[4], int n_out, const void* q,
    const void* k, const void* v, const void* bias, const void* dout,
    const void* lse, const void* delta, void* out0, void* out1, int B, int H,
    int Lq, int Lk, const unsigned long long* geo, const long long* strides,
    int causal, float scale, int dropout_enabled, unsigned long long seed,
    unsigned int threshold, float drop_scale) {
  p.out0 = static_cast<Out*>(out0);
  p.out1 = n_out == 2 ? static_cast<Out*>(out1) : nullptr;
  p.ds = n_out == 1 ? static_cast<float*>(out1) : nullptr;
  p.bias = static_cast<const float*>(bias);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  for (int i = 0; i < 3; ++i) {
    p.out0_st[i] = strides[i];
    p.out1_st[i] = n_out == 2 ? strides[3 + i] : 0;
    p.bias_st[i] = strides[3 * n_out + i];
  }
  p.B = B;
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.causal = causal;
  p.scale = scale;
  p.drop = DropoutParams{seed, threshold, drop_scale, dropout_enabled};
  TmaPos* pos[4] = {&p.pos_q, &p.pos_k, &p.pos_v, &p.pos_do};
  const void* ptrs[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err =
        encode_tensor_map(&maps[i], pos[i], ptrs[i], geo + i * kGeoWords);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Rows r0 and r1 of a 64 x D accumulator (the thread's two rows; a row
// >= n is not stored), times `scale`, at base + row * row_stride.
template <int D, typename Out>
__device__ __forceinline__ void store_rows(Out* base, long long row_stride,
                                           int r0, int r1, int n, int t,
                                           const float (&acc)[D / 2],
                                           float scale) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r == 0 ? r0 : r1;
    if (row >= n) continue;
    Out* dst = base + (long long)row * row_stride;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store_pair(dst + 8 * j + 2 * t, acc[4 * j + 2 * r] * scale,
                 acc[4 * j + 2 * r + 1] * scale);
  }
}

// ------------------------------------------------------------ dQ view
// A consumer thread of a dQ kernel: query rows qi0 and qi1 (accumulator rows
// g and g + 8 of its warp's 16), their LSE, Delta and bias rows. Element
// 4 j + e of a tile of keys k0 .. k0 + 63 is (qi0 if e < 2 else qi1,
// k0 + 8 j + 2 t + e % 2).
struct DqRows {
  int t, qi0, qi1;
  float lse0, lse1, dl0, dl1;
  const float* bias0;
  const float* bias1;
  float* dsb;  // dS of (b, h), or null

  template <typename Out>
  __device__ __forceinline__ DqRows(const BwdParams<Out>& p, int b, int h,
                                    int q0, int tid) {
    const int w = tid / 32, g = (tid % 32) / 4;
    t = tid % 4;
    qi0 = q0 + 16 * w + g;
    qi1 = qi0 + 8;
    const long long row_base = ((long long)b * p.H + h) * p.Lq;
    lse0 = qi0 < p.Lq ? p.lse[row_base + qi0] : 0.f;
    lse1 = qi1 < p.Lq ? p.lse[row_base + qi1] : 0.f;
    dl0 = qi0 < p.Lq ? p.delta[row_base + qi0] : 0.f;
    dl1 = qi1 < p.Lq ? p.delta[row_base + qi1] : 0.f;
    bias0 = nullptr;
    bias1 = nullptr;
    if (p.bias != nullptr) {
      const float* bb = p.bias + b * p.bias_st[0] + h * p.bias_st[1];
      bias0 = bb + (long long)min(qi0, p.Lq - 1) * p.bias_st[2];
      bias1 = bb + (long long)min(qi1, p.Lq - 1) * p.bias_st[2];
    }
    dsb = p.ds == nullptr ? nullptr : p.ds + row_base * p.Lk;
  }

  // The dropout keep bits of the thread's 32 elements (one register).
  template <typename Out>
  __device__ __forceinline__ uint32_t keep_bits(const BwdParams<Out>& p,
                                                int b, int h, int k0) const {
    uint32_t keep = 0xffffffffu;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int qi = (e & 3) < 2 ? qi0 : qi1;
      const int kj = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
      if (qi < p.Lq && kj < p.Lk &&
          dropout_multiplier(p.drop, b, h, qi, kj) == 0.f)
        keep &= ~(1u << e);
    }
    return keep;
  }

  // x = S becomes P = exp(S * scale + bias - LSE), 0 where masked. Only the
  // diagonal tile and the ragged last tile take the mask tests (uniform over
  // the CTA). Rows past Lq need none: a row of dS reaches only its own row
  // of dQ, and neither is stored for them.
  template <typename Out>
  __device__ __forceinline__ void probabilities(const BwdParams<Out>& p,
                                                float (&x)[32], int q0,
                                                int k0) const {
    const bool edge = k0 + 64 > p.Lk || (p.causal && k0 + 63 > q0);
    if (edge) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = e < 2 ? qi0 : qi1;
          const int kj = k0 + 8 * j + 2 * t + (e & 1);
          float pr = 0.f;
          if (!(qi >= p.Lq || kj >= p.Lk || (p.causal && qi < kj))) {
            float v = x[4 * j + e] * p.scale;
            if (bias0 != nullptr) v += (e < 2 ? bias0 : bias1)[kj];
            pr = expf(v - (e < 2 ? lse0 : lse1));
          }
          x[4 * j + e] = pr;
        }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + 8 * j + 2 * t + (e & 1);
          float v = x[4 * j + e] * p.scale;
          if (bias0 != nullptr) v += (e < 2 ? bias0 : bias1)[kj];
          x[4 * j + e] = expf(v - (e < 2 ? lse0 : lse1));
        }
    }
  }

  // dS = P (dP M - Delta), in place of dP; M from the keep bits, each kept
  // element times `kept`.
  __device__ __forceinline__ void grad_scores(const float (&pr)[32],
                                              float (&dp)[32], uint32_t keep,
                                              float kept) const {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        const float mul = (keep >> i) & 1u ? kept : 0.f;
        dp[i] = pr[i] * (dp[i] * mul - (e < 2 ? dl0 : dl1));
      }
  }

  // The float32 dS of the tile at keys k0 .. k0 + 63, masked at the edges.
  __device__ __forceinline__ void store_ds(const float (&ds)[32], int k0,
                                           int Lq, int Lk) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = r == 0 ? qi0 : qi1;
      if (qi >= Lq) continue;
      float* row = dsb + (long long)qi * Lk;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = k0 + 8 * j + 2 * t;
        const float x0 = ds[4 * j + 2 * r], x1 = ds[4 * j + 2 * r + 1];
        if ((Lk & 1) == 0) {
          if (c < Lk) *reinterpret_cast<float2*>(row + c) = make_float2(x0, x1);
        } else {
          if (c < Lk) row[c] = x0;
          if (c + 1 < Lk) row[c + 1] = x1;
        }
      }
    }
  }

  // Causal dS: the key tiles from n_kt on, which no row of the query tile
  // at q0 sees, are zeros (the reference's :259-262; the caller's buffer is
  // uninitialised). `tid` counts the 128 consumer threads.
  __device__ __forceinline__ void zero_unseen_ds(int q0, int n_kt, int Lq,
                                                 int Lk, int tid) const {
    const int c0 = n_kt * 64;
    const int rows = min(64, Lq - q0);
    if ((Lk & 3) == 0) {
      const int n4 = (Lk - c0) / 4;
      for (int idx = tid; idx < rows * n4; idx += 128) {
        const int r = idx / n4;
        *reinterpret_cast<float4*>(dsb + (long long)(q0 + r) * Lk + c0 +
                                   4 * (idx - r * n4)) =
            make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      const int n = Lk - c0;
      for (int idx = tid; idx < rows * n; idx += 128) {
        const int r = idx / n;
        dsb[(long long)(q0 + r) * Lk + c0 + idx - r * n] = 0.f;
      }
    }
  }
};

// ------------------------------------------------------------ dK/dV view
// A consumer thread of a dK/dV kernel: key rows kj0 and kj1 of the
// transposed tile. Element 4 j + e of a tile of queries q0 .. q0 + 63 is
// (key kj0 if e < 2 else kj1, query q0 + 8 j + 2 t + e % 2); the LSE and
// Delta of those queries come as 64 floats each from shared memory.
struct DkvRows {
  int t, kj0, kj1;
  const float* biasb;

  template <typename Out>
  __device__ __forceinline__ DkvRows(const BwdParams<Out>& p, int b, int h,
                                     int kw0, int tid) {
    const int w = (tid % 128) / 32, g = (tid % 32) / 4;
    t = tid % 4;
    kj0 = kw0 + 16 * w + g;
    kj1 = kj0 + 8;
    biasb = p.bias == nullptr ? nullptr
                              : p.bias + b * p.bias_st[0] + h * p.bias_st[1];
  }

  template <typename Out>
  __device__ __forceinline__ uint32_t keep_bits(const BwdParams<Out>& p,
                                                int b, int h, int q0) const {
    uint32_t keep = 0xffffffffu;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + 8 * j + 2 * t + (e & 1);
        const int kj = e < 2 ? kj0 : kj1;
        if (qi < p.Lq && kj < p.Lk &&
            dropout_multiplier(p.drop, b, h, qi, kj) == 0.f)
          keep &= ~(1u << (4 * j + e));
      }
    return keep;
  }

  // x = S^T becomes P^T, 0 where masked; the tests run only on the diagonal
  // and ragged tiles (uniform over the CTA). kw0: the warpgroup's first key.
  template <typename Out>
  __device__ __forceinline__ void probabilities(const BwdParams<Out>& p,
                                                float (&x)[32], int q0,
                                                int kw0,
                                                const float* lse_s) const {
    const bool edge = q0 + 64 > p.Lq || kw0 + 64 > p.Lk ||
                      (p.causal && q0 < kw0 + 63);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        const int qi = q0 + c;
        const int kj = e < 2 ? kj0 : kj1;
        float pr = 0.f;
        if (!edge || !(qi >= p.Lq || kj >= p.Lk || (p.causal && qi < kj))) {
          float v = x[4 * j + e] * p.scale;
          if (biasb != nullptr) v += biasb[(long long)qi * p.bias_st[2] + kj];
          pr = expf(v - lse_s[c]);
        }
        x[4 * j + e] = pr;
      }
  }

  // dS^T = P^T (dP^T M - Delta), in place of dP^T; P^T's element i is
  // `pr(i)` (it may wait in shared memory).
  template <typename Prob>
  __device__ __forceinline__ void grad_scores(Prob pr, float (&dpt)[32],
                                              uint32_t keep, float kept,
                                              const float* delta_s) const {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        const float mul = (keep >> i) & 1u ? kept : 0.f;
        dpt[i] = pr(i) * (dpt[i] * mul - delta_s[8 * j + 2 * t + (e & 1)]);
      }
  }

  // dK * scale and dV through their strides: N columns from column col0.
  template <int N, typename Out>
  __device__ __forceinline__ void store(const BwdParams<Out>& p, int b, int h,
                                        const float (&dk)[N / 2],
                                        const float (&dv)[N / 2],
                                        int col0 = 0) const {
    store_rows<N>(p.out0 + b * p.out0_st[0] + h * p.out0_st[1] + col0,
                  p.out0_st[2], kj0, kj1, p.Lk, t, dk, p.scale);
    store_rows<N>(p.out1 + b * p.out1_st[0] + h * p.out1_st[1] + col0,
                  p.out1_st[2], kj0, kj1, p.Lk, t, dv, 1.f);
  }
};

// The launch of one instantiation over `n_tiles` 64-row tiles per (b, h):
// `smem_set` is that instantiation's own record of the shared-memory opt-in
// (sm90.cuh allow_smem).
template <typename Kernel, typename Out>
inline cudaError_t launch_bwd(Kernel kernel, int threads, size_t smem_bytes,
                              unsigned& smem_set, const CUtensorMap (&m)[4],
                              const BwdParams<Out>& p, int n_tiles,
                              cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, smem_bytes, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, p.B, n_tiles);
  kernel<<<grid, threads, smem_bytes, stream>>>(m[0], m[1], m[2], m[3], p);
  return cudaGetLastError();
}

}  // namespace pt_bwd_sm90
