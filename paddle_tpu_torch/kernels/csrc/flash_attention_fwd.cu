// Flash-attention forward for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces: paddle_tpu/kernels/flash_attention.py `_fwd_kernel` (:131),
// launched by `_flash_fwd_impl` (:352, pallas_call at :383), with its
// in-kernel dropout (`_dropout_mask`, :120; here philox.cuh), at head dim
// 256. Head dims 64 and 128 run on the tensor cores:
// flash_attention_fwd_sm90.cu (bf16) and flash_attention_fwd_f32_sm90.cu
// (float32); the Python wrapper routes by (dtype, D).
//
// Computes, per (b, h):  S = Q K^T * scale (+ bias),  causal mask top-left
// aligned (query i sees key j iff i >= j, masked scores = -1e30 as in the
// TPU kernel), O = dropout(softmax(S)) V and the row log-sum-exp
// LSE = m + log(max(l, 1e-30)).  As in the reference (:170-179), the row sum
// l is taken over the unmasked probabilities and only the P V product sees
// the dropout mask.  Softmax statistics and accumulators are float32 for
// both float32 and bfloat16 inputs; O is written in the input type, LSE as
// float32 [B, H, Lq] (the TPU kernel's 128-lane broadcast of LSE was a
// Mosaic tiling artifact and is not carried over).
//
// Bound on an H100: at L = 1024, D = 256, causal the kernel does
// 2*Lq*Lk*D*H FLOP on about 4*L*D*H*4 bytes, i.e. hundreds of FLOP per
// byte: it is bound by operations, not by HBM. The operations run on the CUDA cores (67 TFLOP/s float32 peak); bf16
// inputs are widened to float32 on load, so they too run at the CUDA-core
// rate, far from the 989 TFLOP/s bf16 tensor-core bound.
//
// Design (GPU, not a block-by-block copy of the Pallas grid):
// - one thread block per (b, h, 64-row query tile); the TPU's sequential 4th
//   grid axis and its VMEM scratch become a loop over 64-key tiles inside the
//   block, with m, l and the output accumulator in registers;
// - causal blocks stop at the diagonal tile, and the grid is walked from the
//   last (most expensive) query tile to the first so long blocks start early;
// - the 16 x 16 thread grid of flash_common.cuh: row max / row sum reduce
//   over 16 lanes of one warp with shuffles and never touch shared memory;
// - Q, K (then V, in the same buffer) and P are staged in shared memory as
//   float32 with padded rows; inputs are read with 16-byte (float32) or
//   8-byte (bfloat16) vector loads;
// - the ragged edge is masked in the kernel (rows past Lq are computed on
//   zeros and not stored, keys past Lk get probability 0), so the TPU's
//   L % 128 tiling rule is gone;
// - dropout draws Philox bits per element (philox.cuh), so the backward
//   kernels regenerate the same mask with their own tiling;
// - plain FMA on the CUDA cores; tensor cores (mma.sync / wgmma) and
//   asynchronous copies (cp.async / TMA) are later work.
//
// The kernel allocates nothing and does not synchronise: the caller passes
// outputs and PyTorch's current stream.

#include "flash_common.cuh"
#include "philox.cuh"

namespace {

using namespace pt_flash;

struct Strides {
  // element strides of the (batch, head, row) dimensions; the last dimension
  // of q/k/v/o is contiguous. A broadcast bias dimension has stride 0.
  long long q[3], k[3], v[3], o[3], bias[3];
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, D <= 128 ? 2 : 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ o, float* __restrict__ lse, int H, int Lq,
                 int Lk, Strides st, int causal, float scale,
                 DropoutParams drop) {
  constexpr int kLd = D + 4;
  constexpr int kGroups = D / 64;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sKV = sQ + kBlockQ * kLd;
  float* sP = sKV + kBlockK * kLd;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kBlockQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int row0 = ty * kRows;  // first of this thread's rows in the tile

  const T* qb = q + b * st.q[0] + h * st.q[1] + q0 * st.q[2];
  const T* kb = k + b * st.k[0] + h * st.k[1];
  const T* vb = v + b * st.v[0] + h * st.v[1];
  const float* biasb =
      bias == nullptr ? nullptr : bias + b * st.bias[0] + h * st.bias[1];

  load_tile<T, D>(sQ, qb, st.q[2], min(kBlockQ, Lq - q0));

  float m[kRows], l[kRows], acc[kRows][kGroups][4];
  zero_acc<D>(acc);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kMaskValue;
    l[i] = 0.f;
  }

  // causal: keys past the tile's last query row are masked for every row
  const int k_end = causal ? min(Lk, q0 + kBlockQ) : Lk;
  const int n_kt = (k_end + kBlockK - 1) / kBlockK;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's P.V is done with sKV and sP
    load_tile<T, D>(sKV, kb + k0 * st.k[2], st.k[2], min(kBlockK, Lk - k0));
    __syncthreads();

    float s[kRows][kCols];
    dot_tile<D>(s, sQ, sKV, row0, tx);

    // ---- scale, bias, masks and the online-softmax update
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + row0 + i;
      float mcur = kMaskValue;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (kj >= Lk) {
          x = -INFINITY;  // ragged edge: probability exactly 0
        } else {
          if (biasb != nullptr && qi < Lq) x += biasb[qi * st.bias[2] + kj];
          if (causal && qi < kj) x = kMaskValue;
        }
        s[i][j] = x;
        mcur = fmaxf(mcur, x);
      }
      const float m_new = fmaxf(m[i], row_max16(mcur));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + tx + 16 * j;
        float p = expf(s[i][j] - m_new);
        psum += p;  // l takes the unmasked probabilities
        if (drop.enabled && qi < Lq && kj < Lk)
          p *= dropout_multiplier(drop, b, h, qi, kj);
        sP[(row0 + i) * kLdP + tx + 16 * j] = p;
      }
      l[i] = alpha * l[i] + row_sum16(psum);
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][g][c] *= alpha;
    }

    __syncthreads();  // every thread is done reading K; P is complete
    load_tile<T, D>(sKV, vb + k0 * st.v[2], st.v[2], min(kBlockK, Lk - k0));
    __syncthreads();

    // ---- acc += P V (V rows past Lk were staged as zeros, P there is 0)
    accumulate_pb<D>(acc, sP, sKV, row0, tx);
  }

  // ---- epilogue: O = acc / l, LSE = m + log(l)
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + row0 + i;
    if (qi >= Lq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / lc;
    T* orow = o + b * st.o[0] + h * st.o[1] + qi * st.o[2];
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
      store4(orow + tx * 4 + 64 * g,
             make_float4(acc[i][g][0] * inv, acc[i][g][1] * inv,
                         acc[i][g][2] * inv, acc[i][g][3] * inv));
    if (tx == 0) lse[((long long)b * H + h) * Lq + qi] = m[i] + logf(lc);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* bias, void* o, float* lse, int B, int H,
                   int Lq, int Lk, const Strides& st, int causal, float scale,
                   const DropoutParams& drop, cudaStream_t stream) {
  constexpr size_t kSmem =
      sizeof(float) * ((kBlockQ + kBlockK) * (D + 4) + kBlockQ * kLdP);
  auto kernel = flash_fwd_kernel<T, D>;
  static std::atomic<unsigned> smem_set{0};
  cudaError_t err = ensure_smem(kernel, kSmem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + kBlockQ - 1) / kBlockQ, H, B);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(o), lse, H, Lq, Lk, st,
      causal, scale, drop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const float* bias, void* o, float* lse, int B, int H,
                       int Lq, int Lk, const Strides& st, int causal,
                       float scale, const DropoutParams& drop,
                       cudaStream_t stream) {
  if (D != 256) return cudaErrorInvalidValue;  // 64, 128: the wgmma kernels
  return launch<T, 256>(q, k, v, bias, o, lse, B, H, Lq, Lk, st, causal,
                        scale, drop, stream);
}

// The dropout bits of a window [B, H, rows, cols] (rows from row0, columns
// from col0), as uint32, contiguous: what every kernel draws there.
__global__ void dropout_bits_kernel(uint32_t* out, unsigned long long seed,
                                    int B, int H, int row0, int nrows,
                                    int col0, int ncols) {
  const long long n = (long long)B * H * nrows * ncols;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % ncols);
    const long long r1 = i / ncols;
    const int r = (int)(r1 % nrows);
    const long long r2 = r1 / nrows;
    const int h = (int)(r2 % H);
    const int b = (int)(r2 / H);
    out[i] = pt_philox::bits(seed, (uint32_t)(col0 + c), (uint32_t)(row0 + r),
                             (uint32_t)h, (uint32_t)b);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: 15 element strides, the
// (batch, head, row) strides of q, k, v, o and bias in that order. bias may
// be null (float32 when given). lse is float32 [B, H, Lq], contiguous.
// D: 256. Dropout is on when dropout_enabled is non-zero: keep iff Philox
// bits >= threshold, kept probabilities times drop_scale.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int pt_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, const void* bias,
                                      void* o, void* lse, int dtype, int B,
                                      int H, int Lq, int Lk, int D,
                                      const long long* strides, int causal,
                                      float scale, int dropout_enabled,
                                      unsigned long long seed,
                                      unsigned int threshold,
                                      float drop_scale, void* stream) {
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
    st.bias[i] = strides[12 + i];
  }
  const DropoutParams drop{seed, threshold, drop_scale, dropout_enabled};
  const float* bias_f = static_cast<const float*>(bias);
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(D, q, k, v, bias_f, o, lse_f, B, H, Lq, Lk,
                                  st, causal, scale, drop, s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(D, q, k, v, bias_f, o, lse_f, B, H,
                                          Lq, Lk, st, causal, scale, drop, s);
  return (int)cudaErrorInvalidValue;
}

// The dropout mask of a window, as the uint32 Philox words it is made of
// (keep iff word >= threshold): writes the words of [B, H, row0 : row0 +
// nrows, col0 : col0 + ncols] into `out` (contiguous). Returns the launch's
// error.
extern "C" int pt_dropout_mask(void* out, unsigned long long seed, int B,
                               int H, int row0, int nrows, int col0,
                               int ncols, void* stream) {
  const long long n = (long long)B * H * nrows * ncols;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const long long want = (n + 255) / 256;
  const int blocks = (int)(want < 4096 ? want : 4096);
  dropout_bits_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), seed, B, H, row0, nrows, col0, ncols);
  return (int)cudaGetLastError();
}
