// Flash-attention forward for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces: paddle_tpu/kernels/flash_attention.py `_fwd_kernel` (:131),
// launched by `_flash_fwd_impl` (:352, pallas_call at :383).
//
// Computes, per (b, h):  S = Q K^T * scale (+ bias),  causal mask top-left
// aligned (query i sees key j iff i >= j, masked scores = -1e30 as in the
// TPU kernel), O = softmax(S) V and the row log-sum-exp
// LSE = m + log(max(l, 1e-30)).  Softmax statistics and accumulators are
// float32 for both float32 and bfloat16 inputs; O is written in the input
// type, LSE as float32 [B, H, Lq] (the TPU kernel's 128-lane broadcast of
// LSE was a Mosaic tiling artifact and is not carried over).
//
// Bound on an H100: at the serving shapes (Lq = Lk up to 2048, D = 128,
// causal) the kernel does 2*Lq*Lk*D*H FLOP on about 4*L*D*H*4 bytes, i.e.
// hundreds of FLOP per byte: it is bound by operations, not by HBM. In
// float32 the operations run on the CUDA cores (67 TFLOP/s peak, no tensor
// cores: TF32 would lose the reference's float32 precision).
//
// Design (GPU, not a block-by-block copy of the Pallas grid):
// - one thread block per (b, h, 64-row query tile); the TPU's sequential 4th
//   grid axis and its VMEM scratch become a loop over 64-key tiles inside the
//   block, with m, l and the output accumulator in registers;
// - causal blocks stop at the diagonal tile, and the grid is walked from the
//   last (most expensive) query tile to the first so long blocks start early;
// - 256 threads as a 16 x 16 grid: a thread owns 4 query rows, 4 columns of
//   each S tile and D/16 columns of the output, so row max / row sum reduce
//   over 16 lanes of one warp with shuffles and never touch shared memory;
// - Q, K (then V, in the same buffer) and P are staged in shared memory as
//   float32 with rows padded by 4 floats, so the 128-bit shared loads of the
//   inner products are free of bank conflicts; inputs are read with 16-byte
//   (float32) or 8-byte (bfloat16) vector loads;
// - the ragged edge is masked in the kernel (rows past Lq are computed on
//   zeros and not stored, keys past Lk get probability 0), so the TPU's
//   L % 128 tiling rule is gone;
// - plain FMA on the CUDA cores; tensor cores (mma.sync / wgmma) and
//   asynchronous copies (cp.async / TMA) are later work.
//
// The kernel allocates nothing and does not synchronise: the caller passes
// outputs and PyTorch's current stream.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kRows = kBlockQ / 16;  // query rows per thread
constexpr int kCols = kBlockK / 16;  // S columns per thread
constexpr int kLdP = kBlockK + 4;    // padded row of the P tile (floats)
constexpr float kMaskValue = -1e30f; // the TPU kernel's _NEG_INF

struct Strides {
  // element strides of the (batch, head, row) dimensions; the last dimension
  // of q/k/v/o is contiguous. A broadcast bias dimension has stride 0.
  long long q[3], k[3], v[3], o[3], bias[3];
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  *reinterpret_cast<uint32_t*>(&lo) = u.x;
  *reinterpret_cast<uint32_t*>(&hi) = u.y;
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float get(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// Stage a [64, D] tile (rows past `rows_valid` as zeros) into shared memory
// as float32 with row pitch D + 4.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride,
                                          int rows_valid) {
  constexpr int kVec = D / 4;
  for (int idx = threadIdx.x; idx < kBlockQ * kVec; idx += kThreads) {
    const int r = idx / kVec;
    const int c = (idx - r * kVec) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows_valid) val = load4(src + r * row_stride + c);
    store4(dst + r * (D + 4) + c, val);
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, D <= 128 ? 2 : 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ o, float* __restrict__ lse, int H, int Lq,
                 int Lk, Strides st, int causal, float scale) {
  constexpr int kLd = D + 4;
  constexpr int kGroups = D / 64;  // 4-wide output column groups per thread
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
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kMaskValue;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][g][c] = 0.f;
  }

  // causal: keys past the tile's last query row are masked for every row
  const int k_end = causal ? min(Lk, q0 + kBlockQ) : Lk;
  const int n_kt = (k_end + kBlockK - 1) / kBlockK;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's P.V is done with sKV and sP
    load_tile<T, D>(sKV, kb + k0 * st.k[2], st.k[2], min(kBlockK, Lk - k0));
    __syncthreads();

    // ---- S = Q K^T for this thread's 4 x 4 block of the tile
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = load4(sQ + (row0 + i) * kLd + d);
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = load4(sKV + (tx + 16 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

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
        const float p = expf(s[i][j] - m_new);
        psum += p;
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
#pragma unroll 2
    for (int kk = 0; kk < kBlockK; kk += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = load4(sP + (row0 + i) * kLdP + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 vv[kGroups];
#pragma unroll
        for (int g = 0; g < kGroups; ++g)
          vv[g] = load4(sKV + (kk + u) * kLd + tx * 4 + 64 * g);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float p = get(pv[i], u);
#pragma unroll
          for (int g = 0; g < kGroups; ++g) {
            acc[i][g][0] = fmaf(p, vv[g].x, acc[i][g][0]);
            acc[i][g][1] = fmaf(p, vv[g].y, acc[i][g][1]);
            acc[i][g][2] = fmaf(p, vv[g].z, acc[i][g][2]);
            acc[i][g][3] = fmaf(p, vv[g].w, acc[i][g][3]);
          }
        }
      }
    }
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
                   cudaStream_t stream) {
  constexpr size_t kSmem =
      sizeof(float) * ((kBlockQ + kBlockK) * (D + 4) + kBlockQ * kLdP);
  auto kernel = flash_fwd_kernel<T, D>;
  // the opt-in above 48 KB is per device: set it on a device's first launch
  // of this instantiation only (one bit per device; devices past 31 always)
  static std::atomic<unsigned> smem_set{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (bit == 0u || !(smem_set.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err != cudaSuccess) return err;
    smem_set.fetch_or(bit, std::memory_order_release);
  }
  const dim3 grid((Lq + kBlockQ - 1) / kBlockQ, H, B);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(o), lse, H, Lq, Lk, st,
      causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const float* bias, void* o, float* lse, int B, int H,
                       int Lq, int Lk, const Strides& st, int causal,
                       float scale, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, bias, o, lse, B, H, Lq, Lk, st, causal,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, bias, o, lse, B, H, Lq, Lk, st, causal,
                            scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, bias, o, lse, B, H, Lq, Lk, st, causal,
                            scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: 15 element strides, the
// (batch, head, row) strides of q, k, v, o and bias in that order. bias may
// be null (float32 when given). lse is float32 [B, H, Lq], contiguous.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int pt_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, const void* bias,
                                      void* o, void* lse, int dtype, int B,
                                      int H, int Lq, int Lk, int D,
                                      const long long* strides, int causal,
                                      float scale, void* stream) {
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
    st.bias[i] = strides[12 + i];
  }
  const float* bias_f = static_cast<const float*>(bias);
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(D, q, k, v, bias_f, o, lse_f, B, H, Lq, Lk,
                                  st, causal, scale, s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(D, q, k, v, bias_f, o, lse_f, B, H,
                                          Lq, Lk, st, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
