// The parts the two Hopper flash-attention forwards share:
// flash_attention_fwd_sm90.cu (bf16 operands) and
// flash_attention_fwd_f32_sm90.cu (float32 operands as three bf16 terms).
// They differ only in how they feed the tensor cores; everything on the
// score tile and the output is here: the parameters and their host-side
// set-up, the CTA's place in the grid, each consumer thread's query rows and
// bias, the online softmax of a 64 x 64 score tile in the wgmma accumulator
// layout (sm90.cuh), the rescale of O, the epilogue and the launch.
//
// Each forward stays a kernel of its own, not a template parameter of one
// kernel: their shared-memory layouts, producers and product loops have
// nothing in common, and code compiled in but skipped cost the bf16 forward
// half its speed (the reason dropout is an instantiation of its own too).

#pragma once

#include "philox.cuh"
#include "sm90.cuh"

namespace pt_fwd_sm90 {

using namespace pt_sm90;

constexpr int kConsumers = 128;  // one warpgroup
constexpr int kThreads = kConsumers + 32;
constexpr float kMaskValue = -1e30f;  // the TPU kernels' _NEG_INF

// Out: the element type of O (__nv_bfloat16 or float).
template <typename Out>
struct FwdParams {
  Out* o;
  float* lse;
  const float* bias;
  long long o_st[3], bias_st[3];  // element strides of (batch, head, row)
  int B, H, Lq, Lk, causal;
  float scale;
  DropoutParams drop;
  TmaPos pos_q, pos_k, pos_v;
};

// The C entries' arguments as kernel parameters and the three tensor maps
// (q, k, v; 14 geometry words each in `geo`). strides[0..2] are O's,
// strides[3..5] the bias's.
template <typename Out>
inline cudaError_t make_fwd_params(
    FwdParams<Out>& p, CUtensorMap (&maps)[3], const void* q, const void* k,
    const void* v, const void* bias, void* o, void* lse, int B, int H, int Lq,
    int Lk, const unsigned long long* geo, const long long* strides,
    int causal, float scale, int dropout_enabled, unsigned long long seed,
    unsigned int threshold, float drop_scale) {
  p.o = static_cast<Out*>(o);
  p.lse = static_cast<float*>(lse);
  p.bias = static_cast<const float*>(bias);
  for (int i = 0; i < 3; ++i) {
    p.o_st[i] = strides[i];
    p.bias_st[i] = strides[3 + i];
  }
  p.B = B;
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.causal = causal;
  p.scale = scale;
  p.drop = DropoutParams{seed, threshold, drop_scale, dropout_enabled};
  cudaError_t err = encode_tensor_map(&maps[0], &p.pos_q, q, geo);
  if (err == cudaSuccess)
    err = encode_tensor_map(&maps[1], &p.pos_k, k, geo + kGeoWords);
  if (err == cudaSuccess)
    err = encode_tensor_map(&maps[2], &p.pos_v, v, geo + 2 * kGeoWords);
  return err;
}

// One CTA per (b, h, 64-row query tile). The query tile is the slowest grid
// dimension, walked from the last: the heaviest causal tiles of every (b, h)
// start first.
struct FwdTile {
  int h, b, q0;
  int n_kt;  // key tiles to visit
};

__device__ __forceinline__ FwdTile fwd_tile(int Lk, int causal) {
  FwdTile c;
  c.h = blockIdx.x;
  c.b = blockIdx.y;
  c.q0 = (gridDim.z - 1 - blockIdx.z) * 64;
  // causal: keys past the tile's last query row are masked for every row
  const int k_end = causal ? min(Lk, c.q0 + 64) : Lk;
  c.n_kt = (k_end + 63) / 64;
  return c;
}

// A consumer thread's two query rows (accumulator rows g and g + 8 of its
// warp's 16), their bias rows and their online-softmax statistics.
struct FwdRows {
  int t, qi0, qi1;
  const float* bias0;
  const float* bias1;
  float m0, m1, l0, l1;

  template <typename Out>
  __device__ __forceinline__ FwdRows(const FwdParams<Out>& p,
                                     const FwdTile& c, int tid) {
    const int w = tid / 32, g = (tid % 32) / 4;
    t = tid % 4;
    qi0 = c.q0 + 16 * w + g;
    qi1 = qi0 + 8;
    bias0 = nullptr;
    bias1 = nullptr;
    if (p.bias != nullptr) {
      const float* bb = p.bias + c.b * p.bias_st[0] + c.h * p.bias_st[1];
      bias0 = bb + (long long)min(qi0, p.Lq - 1) * p.bias_st[2];
      bias1 = bb + (long long)min(qi1, p.Lq - 1) * p.bias_st[2];
    }
    m0 = m1 = kMaskValue;
    l0 = l1 = 0.f;
  }

  // Scale, bias, masks, dropout and the online-softmax statistics of the
  // score tile `x` of keys k0 .. k0 + 63, in place (x becomes P); returns
  // the factors exp(m_old - m_new) by which O must be rescaled. kDropout:
  // the draws are compiled only into the instantiation that uses them.
  template <bool kDropout, typename Out>
  __device__ __forceinline__ void softmax(const FwdParams<Out>& p,
                                          const FwdTile& c, float (&x)[32],
                                          int k0, float& alpha0,
                                          float& alpha1) {
    // Only the diagonal tile and the ragged last tile need the masks: the
    // test is uniform over the CTA, so the other tiles skip them.
    const bool edge = k0 + 64 > p.Lk || (p.causal && k0 + 63 > c.q0);
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
            x[4 * j + e] *= dropout_multiplier(p.drop, c.b, c.h, qi, kj);
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
  }

  // Epilogue: O = acc / l written through its strides, LSE = m + log(l).
  template <int D, typename Out>
  __device__ __forceinline__ void store(const FwdParams<Out>& p,
                                        const FwdTile& c,
                                        const float (&o)[D / 2]) const {
    const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
    const float inv0 = 1.f / lc0, inv1 = 1.f / lc1;
    Out* ob = p.o + c.b * p.o_st[0] + c.h * p.o_st[1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = r == 0 ? qi0 : qi1;
      if (qi >= p.Lq) continue;
      const float inv = r == 0 ? inv0 : inv1;
      Out* orow = ob + (long long)qi * p.o_st[2];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        store_pair(orow + 8 * j + 2 * t, o[4 * j + 2 * r] * inv,
                   o[4 * j + 2 * r + 1] * inv);
      if (t == 0)
        p.lse[((long long)c.b * p.H + c.h) * p.Lq + qi] =
            (r == 0 ? m0 : m1) + logf(r == 0 ? lc0 : lc1);
    }
  }
};

// O *= exp(m_old - m_new), row by row, in the accumulator layout.
template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2], float alpha0,
                                        float alpha1) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j] *= alpha0;
    o[4 * j + 1] *= alpha0;
    o[4 * j + 2] *= alpha1;
    o[4 * j + 3] *= alpha1;
  }
}

// The launch of one instantiation: `smem_set` is that instantiation's own
// record of the shared-memory opt-in (sm90.cuh allow_smem).
template <typename Kernel, typename Out>
inline cudaError_t launch_fwd(Kernel kernel, size_t smem_bytes,
                              unsigned& smem_set, const CUtensorMap (&m)[3],
                              const FwdParams<Out>& p, cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, smem_bytes, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, p.B, (p.Lq + 63) / 64);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(m[0], m[1], m[2], p);
  return cudaGetLastError();
}

}  // namespace pt_fwd_sm90
