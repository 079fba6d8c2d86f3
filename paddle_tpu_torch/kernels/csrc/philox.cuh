// Philox4x32-10, keyed per attention element, for in-kernel dropout.
//
// Replaces: paddle_tpu/kernels/flash_attention.py `_dropout_mask` (:120),
// which seeds the TPU PRNG with (seed, block id) and draws one uint32 per
// element of a (block_q, block_k) tile.
//
// Here the random bits of element (b, h, row, col) are the first output
// word of Philox4x32-10 (Salmon et al., SC'11; the Random123 constants) with
//   counter = (col, row, h, b),  key = (seed low 32 bits, seed high 32 bits).
// The bits depend on the element alone, not on any tiling, so the forward
// kernel and both backward kernels regenerate the same mask although they
// walk the [Lq, Lk] plane in different tiles and orders.
//
// The reference's rule is kept: keep = bits >= min(int(p * 2^32), 2^32 - 1),
// and kept values are scaled by 1 / (1 - p).
//
// The plain PyTorch version (`philox_bits` in kernels/flash_attention.py)
// computes the same uint32 words with 64-bit integer tensor ops and must
// equal this one bit for bit.

#pragma once

#include <stdint.h>

namespace pt_philox {

constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;

__device__ __forceinline__ uint32_t bits(uint64_t seed, uint32_t c0,
                                         uint32_t c1, uint32_t c2,
                                         uint32_t c3) {
  uint32_t k0 = static_cast<uint32_t>(seed);
  uint32_t k1 = static_cast<uint32_t>(seed >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kM0, c0);
    const uint32_t lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2);
    const uint32_t lo1 = kM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += kW0;
    k1 += kW1;
  }
  return c0;
}

}  // namespace pt_philox

// Dropout parameters of one attention call, passed by value to the kernels.
struct DropoutParams {
  unsigned long long seed;
  unsigned int threshold;  // keep iff bits >= threshold
  float scale;             // 1 / (1 - p), as float32
  int enabled;             // p > 0
};

// The multiplier of element (b, h, row, col): 0 (dropped) or 1 / (1 - p).
__device__ __forceinline__ float dropout_multiplier(const DropoutParams& d,
                                                   int b, int h, int row,
                                                   int col) {
  const uint32_t r = pt_philox::bits(d.seed, static_cast<uint32_t>(col),
                                     static_cast<uint32_t>(row),
                                     static_cast<uint32_t>(h),
                                     static_cast<uint32_t>(b));
  return r >= d.threshold ? d.scale : 0.f;
}
