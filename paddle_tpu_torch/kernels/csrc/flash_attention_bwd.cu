// Flash-attention backward for Hopper (sm_90a): the dQ kernel and the dK/dV
// kernel, CUDA C++ with plain C entries.
//
// Replaces: paddle_tpu/kernels/flash_attention.py `_bwd_dq_kernel` (:198,
// pallas_call at :466) and `_bwd_dkv_kernel` (:269, pallas_call at :513),
// both launched by `_flash_bwd_impl` (:411): the FlashAttention-2
// decomposition of the backward pass.
//
// With P = exp(S * scale + bias - LSE) (0 above the top-left causal
// diagonal and past the ragged edge), M the dropout multiplier of each
// element (0 or 1 / (1 - p), philox.cuh; 1 without dropout) and
// Delta = rowsum(dO * O) computed by the caller:
//   dP = (dO V^T) * M,   dS = P * (dP - Delta),
//   dQ = dS K * scale,   dK = dS^T Q * scale,   dV = (P * M)^T dO,
// and, when the bias is trained, dS itself as float32 [B, H, Lq, Lk]
// (tiles skipped by the causal mask are written as zeros, as at :259-262).
// Arithmetic and accumulators are float32 for float32 and bfloat16 inputs
// (the reference's default `_operand_dtype`); dQ, dK, dV are written in the
// input type.
//
// Bound on an H100: per kept (query, key) pair the dQ kernel does 3 inner
// products of length D (Q K^T, dO V^T, dS K) and the dK/dV kernel 4
// (K Q^T, V dO^T, P^T dO, dS^T Q): 6D and 8D FLOP, against a few bytes per
// row of HBM traffic, so both are bound by operations (the dS output, when
// asked for, adds 4 bytes per pair). They run on the CUDA cores in FMA,
// like the forward kernel. No route takes them any longer: bf16 takes
// flash_attention_bwd_{dq,dkv}_sm90.cu at every head dim, float32
// flash_attention_bwd_f32_sm90.cu (D 64/128) and
// flash_attention_bwd_f32_d256_sm90.cu (D = 256), on the tensor cores.
// They stay as the yardstick chip_smoke.py times those kernels against.
//
// Design:
// - dQ: one 256-thread block per (b, h, 64-row query tile), looping over
//   64-key tiles up to the diagonal; Q and dO stay in shared memory, K and V
//   take turns in one buffer (K for S, V for dP, K again for dS K), so
//   D = 256 fits in 217 KB; dQ accumulates in registers.
// - dK/dV: one block per (b, h, 64-key tile), looping over the query tiles
//   from the diagonal on; K and V stay in shared memory, Q and dO take turns
//   in one buffer; the thread owns 4 key rows of the transposed score tile,
//   so (P * M)^T dO and dS^T Q are the same row-times-tile product as P V in
//   the forward; dK and dV accumulate in registers.
// - the mask is regenerated per element from (seed, b, h, query, key), so
//   both kernels see the forward's mask although they tile differently;
// - no atomics: every output element is written by one thread, so a run is
//   deterministic and replays bit for bit.
//
// The kernels allocate nothing and do not synchronise.

#include "flash_common.cuh"
#include "philox.cuh"

namespace {

using namespace pt_flash;

struct BwdStrides {
  // element strides of the (batch, head, row) dimensions; the last
  // dimension of every [B, H, L, D] operand is contiguous. A broadcast bias
  // dimension has stride 0.
  long long q[3], k[3], v[3], dout[3], dq[3], dk[3], dv[3], bias[3];
};

template <int D>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (3 * kBlockQ * (D + 4) + kBlockQ * kLdP);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    float* __restrict__ ds_out, int H, int Lq, int Lk,
                    BwdStrides st, int causal, float scale,
                    DropoutParams drop) {
  constexpr int kLd = D + 4;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sdO = sQ + kBlockQ * kLd;
  float* sKV = sdO + kBlockQ * kLd;
  float* sS = sKV + kBlockK * kLd;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kBlockQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int row0 = ty * kRows;
  const int rows_valid = min(kBlockQ, Lq - q0);

  const T* kb = k + b * st.k[0] + h * st.k[1];
  const T* vb = v + b * st.v[0] + h * st.v[1];
  const float* biasb =
      bias == nullptr ? nullptr : bias + b * st.bias[0] + h * st.bias[1];
  const long long row_base = ((long long)b * H + h) * Lq;
  float* dsb = ds_out == nullptr ? nullptr : ds_out + row_base * Lk;

  load_tile<T, D>(sQ, q + b * st.q[0] + h * st.q[1] + q0 * st.q[2], st.q[2],
                  rows_valid);
  load_tile<T, D>(sdO, dout + b * st.dout[0] + h * st.dout[1] +
                           q0 * st.dout[2], st.dout[2], rows_valid);
  float lse_r[kRows], delta_r[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + row0 + i;
    lse_r[i] = qi < Lq ? lse[row_base + qi] : 0.f;
    delta_r[i] = qi < Lq ? delta[row_base + qi] : 0.f;
  }

  float acc[kRows][D / 64][4];
  zero_acc<D>(acc);

  const int k_end = causal ? min(Lk, q0 + kBlockQ) : Lk;
  const int n_kt = (k_end + kBlockK - 1) / kBlockK;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    const int keys_valid = min(kBlockK, Lk - k0);
    __syncthreads();  // the previous tile's dS K is done with sKV and sS
    load_tile<T, D>(sKV, kb + k0 * st.k[2], st.k[2], keys_valid);
    __syncthreads();

    // ---- P = exp(S * scale + bias - LSE), 0 where masked
    float p[kRows][kCols];
    dot_tile<D>(p, sQ, sKV, row0, tx);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + row0 + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + tx + 16 * j;
        if (qi >= Lq || kj >= Lk || (causal && qi < kj)) {
          p[i][j] = 0.f;
        } else {
          float x = p[i][j] * scale;
          if (biasb != nullptr) x += biasb[qi * st.bias[2] + kj];
          p[i][j] = expf(x - lse_r[i]);
        }
      }
    }

    __syncthreads();  // every thread is done reading K
    load_tile<T, D>(sKV, vb + k0 * st.v[2], st.v[2], keys_valid);
    __syncthreads();

    // ---- dP = dO V^T (* M);  dS = P * (dP - Delta)
    float dp[kRows][kCols];
    dot_tile<D>(dp, sdO, sKV, row0, tx);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + row0 + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool inside = qi < Lq && kj < Lk;
        float d = dp[i][j];
        if (drop.enabled && inside) d *= dropout_multiplier(drop, b, h, qi, kj);
        const float ds = p[i][j] * (d - delta_r[i]);
        sS[(row0 + i) * kLdP + tx + 16 * j] = ds;
        if (dsb != nullptr && inside) dsb[(long long)qi * Lk + kj] = ds;
      }
    }

    __syncthreads();  // every thread is done reading V; dS is complete
    load_tile<T, D>(sKV, kb + k0 * st.k[2], st.k[2], keys_valid);
    __syncthreads();

    // ---- dQ += dS K
    accumulate_pb<D>(acc, sS, sKV, row0, tx);
  }

  // causal: dS of the key tiles this block skipped is zero
  if (dsb != nullptr && causal) {
    const int c0 = n_kt * kBlockK;
    const int ncols = Lk - c0;
    for (int idx = threadIdx.x; ncols > 0 && idx < rows_valid * ncols;
         idx += kThreads) {
      const int r = idx / ncols;
      const int c = idx - r * ncols;
      dsb[(long long)(q0 + r) * Lk + c0 + c] = 0.f;
    }
  }

  store_rows<T, D>(dq + b * st.dq[0] + h * st.dq[1] + q0 * st.dq[2],
                   st.dq[2], acc, scale, row0, rows_valid, tx);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Lq, int Lk, BwdStrides st,
                     int causal, float scale, DropoutParams drop) {
  constexpr int kLd = D + 4;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + kBlockK * kLd;
  float* sX = sV + kBlockK * kLd;  // Q or dO of the current query tile
  float* sP = sX + kBlockQ * kLd;  // (P * M)^T, then dS^T

  const int kt = blockIdx.x;  // causal: the early key tiles see most queries
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = kt * kBlockK;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int row0 = ty * kRows;  // this thread's key rows in the tile
  const int keys_valid = min(kBlockK, Lk - k0);

  const T* qb = q + b * st.q[0] + h * st.q[1];
  const T* dob = dout + b * st.dout[0] + h * st.dout[1];
  const float* biasb =
      bias == nullptr ? nullptr : bias + b * st.bias[0] + h * st.bias[1];
  const long long row_base = ((long long)b * H + h) * Lq;

  load_tile<T, D>(sK, k + b * st.k[0] + h * st.k[1] + k0 * st.k[2], st.k[2],
                  keys_valid);
  load_tile<T, D>(sV, v + b * st.v[0] + h * st.v[1] + k0 * st.v[2], st.v[2],
                  keys_valid);

  float acc_dk[kRows][D / 64][4], acc_dv[kRows][D / 64][4];
  zero_acc<D>(acc_dk);
  zero_acc<D>(acc_dv);

  // causal (top-left): query tile qt holds a kept pair of this key tile
  // iff its last row reaches k0, i.e. qt >= kt (equal tile sizes)
  const int n_qt = (Lq + kBlockQ - 1) / kBlockQ;
  for (int qt = causal ? kt : 0; qt < n_qt; ++qt) {
    const int q0 = qt * kBlockQ;
    const int rows_valid = min(kBlockQ, Lq - q0);
    float lse_c[kCols], delta_c[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int qi = q0 + tx + 16 * j;
      lse_c[j] = qi < Lq ? lse[row_base + qi] : 0.f;
      delta_c[j] = qi < Lq ? delta[row_base + qi] : 0.f;
    }
    __syncthreads();  // the previous tile's dS^T Q is done with sX and sP
    load_tile<T, D>(sX, qb + q0 * st.q[2], st.q[2], rows_valid);
    __syncthreads();

    // ---- P^T[key, query] = exp(K Q^T * scale + bias - LSE), 0 if masked
    float p[kRows][kCols];
    dot_tile<D>(p, sK, sX, row0, tx);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int kj = k0 + row0 + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int qi = q0 + tx + 16 * j;
        if (qi >= Lq || kj >= Lk || (causal && qi < kj)) {
          p[i][j] = 0.f;
        } else {
          float x = p[i][j] * scale;
          if (biasb != nullptr) x += biasb[qi * st.bias[2] + kj];
          p[i][j] = expf(x - lse_c[j]);
        }
      }
    }

    __syncthreads();  // every thread is done reading Q
    load_tile<T, D>(sX, dob + q0 * st.dout[2], st.dout[2], rows_valid);
    __syncthreads();

    // ---- dP^T = V dO^T (* M); write (P * M)^T; keep dS^T in registers
    float dp[kRows][kCols];
    dot_tile<D>(dp, sV, sX, row0, tx);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int kj = k0 + row0 + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int qi = q0 + tx + 16 * j;
        float mul = 1.f;
        if (drop.enabled && qi < Lq && kj < Lk)
          mul = dropout_multiplier(drop, b, h, qi, kj);
        sP[(row0 + i) * kLdP + tx + 16 * j] = p[i][j] * mul;
        dp[i][j] = p[i][j] * (dp[i][j] * mul - delta_c[j]);
      }
    }
    __syncthreads();

    // ---- dV += (P * M)^T dO
    accumulate_pb<D>(acc_dv, sP, sX, row0, tx);

    __syncthreads();  // every thread is done reading sP and dO
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        sP[(row0 + i) * kLdP + tx + 16 * j] = dp[i][j];
    load_tile<T, D>(sX, qb + q0 * st.q[2], st.q[2], rows_valid);
    __syncthreads();

    // ---- dK += dS^T Q
    accumulate_pb<D>(acc_dk, sP, sX, row0, tx);
  }

  store_rows<T, D>(dk + b * st.dk[0] + h * st.dk[1] + k0 * st.dk[2],
                   st.dk[2], acc_dk, scale, row0, keys_valid, tx);
  store_rows<T, D>(dv + b * st.dv[0] + h * st.dv[1] + k0 * st.dv[2],
                   st.dv[2], acc_dv, 1.f, row0, keys_valid, tx);
}

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *bias, *lse, *delta;
  void *dq, *dk, *dv;
  float* ds;
  int B, H, Lq, Lk;
  BwdStrides st;
  int causal;
  float scale;
  DropoutParams drop;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const BwdArgs& a) {
  constexpr size_t kSmem = bwd_smem_bytes<D>();
  auto kernel = flash_bwd_dq_kernel<T, D>;
  static std::atomic<unsigned> smem_set{0};
  cudaError_t err = ensure_smem(kernel, kSmem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + kBlockQ - 1) / kBlockQ, a.H, a.B);
  kernel<<<grid, kThreads, kSmem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.bias, static_cast<const T*>(a.dout),
      a.lse, a.delta, static_cast<T*>(a.dq), a.ds, a.H, a.Lq, a.Lk, a.st,
      a.causal, a.scale, a.drop);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const BwdArgs& a) {
  constexpr size_t kSmem = bwd_smem_bytes<D>();
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  static std::atomic<unsigned> smem_set{0};
  cudaError_t err = ensure_smem(kernel, kSmem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lk + kBlockK - 1) / kBlockK, a.H, a.B);
  kernel<<<grid, kThreads, kSmem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.bias, static_cast<const T*>(a.dout),
      a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H,
      a.Lq, a.Lk, a.st, a.causal, a.scale, a.drop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int which, int D, const BwdArgs& a) {
  switch (D) {
    case 64:
      return which == 0 ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
    case 128:
      return which == 0 ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
    case 256:
      return which == 0 ? launch_dq<T, 256>(a) : launch_dkv<T, 256>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

int run(int which, const void* q, const void* k, const void* v,
        const void* bias, const void* dout, const void* lse,
        const void* delta, void* out0, void* out1, void* ds, int dtype,
        int B, int H, int Lq, int Lk, int D, const long long* strides,
        int causal, float scale, int dropout_enabled,
        unsigned long long seed, unsigned int threshold, float drop_scale,
        void* stream) {
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.bias = static_cast<const float*>(bias);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = which == 0 ? out0 : nullptr;
  a.dk = which == 1 ? out0 : nullptr;
  a.dv = which == 1 ? out1 : nullptr;
  a.ds = static_cast<float*>(ds);
  a.B = B;
  a.H = H;
  a.Lq = Lq;
  a.Lk = Lk;
  for (int i = 0; i < 3; ++i) {
    a.st.q[i] = strides[i];
    a.st.k[i] = strides[3 + i];
    a.st.v[i] = strides[6 + i];
    a.st.dout[i] = strides[9 + i];
    a.st.dq[i] = strides[12 + i];
    a.st.dk[i] = strides[15 + i];
    a.st.dv[i] = strides[18 + i];
    a.st.bias[i] = strides[21 + i];
  }
  a.causal = causal;
  a.scale = scale;
  a.drop = DropoutParams{seed, threshold, drop_scale, dropout_enabled};
  a.stream = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(which, D, a);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(which, D, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Both entries: dtype 0 = float32, 1 = bfloat16 (q, k, v, dout and the
// gradients); bias (may be null), lse and delta are float32, lse and delta
// contiguous [B, H, Lq]. strides: 24 element strides, the (batch, head, row)
// strides of q, k, v, dout, dq, dk, dv and bias in that order (the unused
// gradients' entries are ignored). Dropout as in pt_flash_attention_fwd.
// Each returns the cudaError_t of its launch (0 on success).

// dQ, and dS (float32 [B, H, Lq, Lk], contiguous) when `ds` is not null.
extern "C" int pt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* bias,
    const void* dout, const void* lse, const void* delta, void* dq, void* ds,
    int dtype, int B, int H, int Lq, int Lk, int D, const long long* strides,
    int causal, float scale, int dropout_enabled, unsigned long long seed,
    unsigned int threshold, float drop_scale, void* stream) {
  return run(0, q, k, v, bias, dout, lse, delta, dq, nullptr, ds, dtype, B, H,
             Lq, Lk, D, strides, causal, scale, dropout_enabled, seed,
             threshold, drop_scale, stream);
}

// dK and dV.
extern "C" int pt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* bias,
    const void* dout, const void* lse, const void* delta, void* dk, void* dv,
    int dtype, int B, int H, int Lq, int Lk, int D, const long long* strides,
    int causal, float scale, int dropout_enabled, unsigned long long seed,
    unsigned int threshold, float drop_scale, void* stream) {
  return run(1, q, k, v, bias, dout, lse, delta, dk, dv, nullptr, dtype, B, H,
             Lq, Lk, D, strides, causal, scale, dropout_enabled, seed,
             threshold, drop_scale, stream);
}
