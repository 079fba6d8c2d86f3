// Building blocks shared by the flash-attention kernels (forward and the two
// backward kernels): the 64 x 64 tile geometry, vector loads of float32 and
// bfloat16 rows, staging of [64, D] tiles into shared memory as float32, and
// the two FMA inner loops every kernel is made of.
//
// Thread layout (256 threads as a 16 x 16 grid, tx = thread & 15,
// ty = thread >> 4): in a 64 x 64 score tile a thread owns rows
// ty*4 .. ty*4+3 and columns tx, tx+16, tx+32, tx+48; in a 64 x D output
// tile it owns the same 4 rows and the 4-wide column groups tx*4 + 64*g.
// Shared-memory rows are padded by 4 floats so the 128-bit shared loads of
// both inner loops are free of bank conflicts.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

namespace pt_flash {

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kRows = kBlockQ / 16;  // tile rows per thread
constexpr int kCols = kBlockK / 16;  // score columns per thread
constexpr int kLdP = kBlockK + 4;    // padded row of a 64 x 64 tile (floats)
constexpr float kMaskValue = -1e30f; // the TPU kernels' _NEG_INF

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

// s[i][j] = A[row0 + i] . B[tx + 16 j] over D, for two [64, D] tiles staged
// by load_tile: this thread's 4 x 4 block of A B^T.
template <int D>
__device__ __forceinline__ void dot_tile(float (&s)[kRows][kCols],
                                         const float* sA, const float* sB,
                                         int row0, int tx) {
  constexpr int kLd = D + 4;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[kRows], bv[kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) av[i] = load4(sA + (row0 + i) * kLd + d);
#pragma unroll
    for (int j = 0; j < kCols; ++j) bv[j] = load4(sB + (tx + 16 * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = fmaf(av[i].x, bv[j].x, s[i][j]);
        s[i][j] = fmaf(av[i].y, bv[j].y, s[i][j]);
        s[i][j] = fmaf(av[i].z, bv[j].z, s[i][j]);
        s[i][j] = fmaf(av[i].w, bv[j].w, s[i][j]);
      }
  }
}

// acc[i] += P[row0 + i, :] B, for a 64 x 64 tile P (pitch kLdP) and a
// [64, D] tile B staged by load_tile: this thread's 4 rows x D/16 columns.
template <int D>
__device__ __forceinline__ void accumulate_pb(
    float (&acc)[kRows][D / 64][4], const float* sP, const float* sB,
    int row0, int tx) {
  constexpr int kLd = D + 4;
  constexpr int kGroups = D / 64;
#pragma unroll 2
  for (int kk = 0; kk < kBlockK; kk += 4) {
    float4 pv[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) pv[i] = load4(sP + (row0 + i) * kLdP + kk);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float4 bv[kGroups];
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
        bv[g] = load4(sB + (kk + u) * kLd + tx * 4 + 64 * g);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = get(pv[i], u);
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          acc[i][g][0] = fmaf(p, bv[g].x, acc[i][g][0]);
          acc[i][g][1] = fmaf(p, bv[g].y, acc[i][g][1]);
          acc[i][g][2] = fmaf(p, bv[g].z, acc[i][g][2]);
          acc[i][g][3] = fmaf(p, bv[g].w, acc[i][g][3]);
        }
      }
    }
  }
}

// Store this thread's 4 rows x D/16 columns of acc * mul into row-strided
// `out` (rows past `rows_valid` are not written).
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* out, long long row_stride,
                                           const float (&acc)[kRows][D / 64][4],
                                           float mul, int row0, int rows_valid,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (row0 + i >= rows_valid) continue;
    T* orow = out + (row0 + i) * row_stride;
#pragma unroll
    for (int g = 0; g < D / 64; ++g)
      store4(orow + tx * 4 + 64 * g,
             make_float4(acc[i][g][0] * mul, acc[i][g][1] * mul,
                         acc[i][g][2] * mul, acc[i][g][3] * mul));
  }
}

template <int D>
__device__ __forceinline__ void zero_acc(float (&acc)[kRows][D / 64][4]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int g = 0; g < D / 64; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][g][c] = 0.f;
}

// The opt-in above 48 KB of dynamic shared memory is per device and per
// kernel: set it on a device's first launch of `kernel` only (one bit per
// device in `done`; devices past 31 set it on every launch).
template <typename Kernel>
cudaError_t ensure_smem(Kernel kernel, size_t bytes,
                        std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (bit != 0u && (done.load(std::memory_order_acquire) & bit)) {
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace pt_flash
