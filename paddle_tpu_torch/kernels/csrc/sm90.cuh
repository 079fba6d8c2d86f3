// Hopper (sm_90a) building blocks for the tensor-core kernels: TMA tile
// loads completed on mbarriers, wgmma shared-memory descriptors, the three
// wgmma forms the attention kernels use, the split of a float32
// fragment, the term-pair products of the float32 (wgmma_f32) kernels, and
// the host-side encoding of a tensor map. All device code is inline PTX (no
// CUTLASS/CuTe).
//
// Shared-memory tile layout. Every operand tile is 64 rows of a [rows, D]
// bf16 matrix (D = 64, 128 or 256), loaded by TMA with
// CU_TENSOR_MAP_SWIZZLE_128B. That swizzle caps a box's inner extent at 128
// bytes, so a row of D = 128 is two boxes and one of D = 256 four: the tile
// is stored as D / 64 "atoms", atom a holding columns
// 64a .. 64a + 63 of all 64 rows (64 x 128 B = 8 KB), each atom 1024-byte
// aligned, rows 128 B apart and XOR-swizzled in groups of 8 rows (1024 B).
//
// The same tile serves wgmma in two ways:
// - K-major (the tile's columns are the reduction dimension: Q and K in
//   S = Q K^T): the k-th 16-column slice starts at atom k / 4, byte
//   32 * (k % 4) of its first row; LBO is unused by swizzled K-major
//   layouts (16 B by convention), SBO = 1024 B, the step between 8-row
//   groups.
// - MN-major, i.e. transposed B (the tile's rows are the reduction
//   dimension: V in P V, dO and Q in the dK/dV products): the k-th 16-row
//   slice starts 16 rows (2048 B) further on; SBO = 1024 B steps 8 rows
//   along K, LBO = 8 KB steps from one 64-column atom to the next along N.
//   A product over the columns 128 h .. 128 h + 127 of a D = 256 tile (the
//   dK/dV kernel's halves) starts its descriptor 2 h atoms in.
// A wrong descriptor gives a plausible wrong answer, not a fault; the
// exported pt_sm90_selfcheck runs both forms against torch.matmul.
//
// Fragments (PTX ISA, wgmma register fragments). Thread `lane` of warp w of
// a warpgroup, g = lane / 4, t = lane % 4, holds of an m64nN float32
// accumulator d[4 j + e] = D[16 w + g + 8 (e / 2)][8 j + 2 t + (e % 2)].
// The A fragment of an m64k16 bf16 operand in registers is four bf16x2
// words: a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..],
// a3 = A[g+8][2t+8..] (rows offset by 16 w). So the accumulator's elements
// 8 kk .. 8 kk + 7 are, pairwise, the A fragment of its kk-th 16-column
// slice: a score tile feeds the next product without leaving registers.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pt_sm90 {

constexpr int kAtomBytes = 64 * 128;  // one 64-row x 128-byte swizzle atom

// ------------------------------------------------------------ addresses
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase `parity` has completed. A protocol fault
// would spin forever and hold the card, so after 2^21 polls (seconds; no
// wait of a working kernel comes near) the wait traps: the launch then
// fails with an error instead.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls > (1u << 21)) __trap();
  }
}

// ------------------------------------------------------------ TMA
// Where the (row, head, batch) coordinates of a [B, H, L, D] tensor sit in
// its 4-D tensor map (dimension 0 is always D): the map orders the three
// outer dimensions by stride, which the Python side picks per tensor.
struct TmaPos {
  int row, head, batch;
};

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// Load rows row0 .. row0 + 63 of head h, batch b (rows past the tensor's end
// arrive as zeros) into the tile at `dst`, one 64-column atom per TMA box.
// Completes 64 * D * 2 bytes on `bar`.
template <int D>
__device__ __forceinline__ void tma_load_tile(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int row0, int h,
                                              int b, TmaPos pos) {
  const int c1 = pos.row == 1 ? row0 : (pos.head == 1 ? h : b);
  const int c2 = pos.row == 2 ? row0 : (pos.head == 2 ? h : b);
  const int c3 = pos.row == 3 ? row0 : (pos.head == 3 ? h : b);
#pragma unroll
  for (int a = 0; a < D / 64; ++a)
    tma_load_4d(dst + a * kAtomBytes, map, bar, 64 * a, c1, c2, c3);
}

// ------------------------------------------------------------ wgmma
__device__ __forceinline__ uint64_t desc_encode(uint32_t addr, uint32_t lbo,
                                                uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (1ull << 62);  // 128-byte swizzle
}

// The k-th 16-column slice of a K-major tile (see the layout note above).
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int k) {
  return desc_encode(tile + (k >> 2) * kAtomBytes + (k & 3) * 32, 16, 1024);
}

// The k-th 16-row slice of an MN-major (transposed B) tile.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int k) {
  return desc_encode(tile + k * 16 * 128, kAtomBytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across a
// wgmma fence or wait (the asynchronous product owns the registers between).
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A in registers (the fragment of
// `a`), B MN-major (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A in registers (the fragment of
// `a`), B MN-major (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_n128_tb(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D[64 x 256] (+)= A[64 x 16] B[16 x 256], A in registers (the fragment of
// `a`), B MN-major (transposed) in shared memory: the four 64-column atoms
// of a D = 256 tile, LBO apart.
__device__ __forceinline__ void wgmma_rs_n256_tb(float (&d)[128],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D[64 x N] += A B for an A fragment in registers and a transposed B tile.
template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  if constexpr (N == 64) {
    wgmma_rs_n64_tb(d, a, desc_b, 1);
  } else if constexpr (N == 128) {
    wgmma_rs_n128_tb(d, a, desc_b, 1);
  } else {
    static_assert(N == 256, "wgmma_rs_tb: N must be 64, 128 or 256");
    wgmma_rs_n256_tb(d, a, desc_b, 1);
  }
}

// ------------------------------------------------------------ bf16 split
__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two adjacent output values, as bf16 or float32.
__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

// The float32 operands the kernels make (P, dS) enter bf16 wgmmas as the
// sum of kSplit bf16 terms: x = t0 + t1 + t2 + e with t0 = bf16(x),
// t1 = bf16(x - t0), t2 = bf16(x - t0 - t1). Each difference is exact in
// float32 and each rounding keeps 8 significant bits (relative error
// <= 2^-8), so |e| <= 2^-24 |x|, float32's own unit roundoff: sum_i t_i.B
// is the float32-operand product to float32's own rounding.
// (Two terms leave 2^-16 |x|, which shows on outputs that cancel to near
// zero: a softmax row of two keys gives O ~ 1e-6 off by 2e-6.)
constexpr int kSplit = 3;

// The A fragments of the kSplit terms of the kk-th 16-column slice of a
// float32 64 x 64 accumulator whose element i is `a(i)` (the slice is
// elements 8 kk .. 8 kk + 7). `a` may compute the values, so that a scaled
// or masked copy of an accumulator need not be held whole.
template <typename Elem>
__device__ __forceinline__ void split_slice(Elem a, int kk,
                                            uint32_t (&f)[kSplit][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float x0 = a(8 * kk + 2 * r), x1 = a(8 * kk + 2 * r + 1);
#pragma unroll
    for (int term = 0; term < kSplit; ++term) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(h);
      f[term][r] = bf16x2_bits(h);
      x0 -= hf.x;
      x1 -= hf.y;
    }
  }
}

// An asynchronous wgmma reads its register A operand after it is issued,
// and the compiler, which sees an ordinary asm statement, could reuse those
// registers at once. Touching the fragments after the wgmma wait keeps them
// live (and unchanged) until the product has read them.
template <int M>
__device__ __forceinline__ void fence_fragments(uint32_t (&f)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(f[i][r])::"memory");
}

// D[64 x N] += A B for a float32 64 x 64 matrix A with element i `a(i)`,
// taken as its kSplit bf16 terms, waited for. kSliceWait commits and waits
// per 16-column slice, so only that slice's values and fragments are live:
// fewer registers (the dK/dV kernel needs that beside its two
// accumulators), at the price of three more waits.
template <int N, bool kSliceWait, typename Elem>
__device__ __forceinline__ void wgmma_split_product(float (&d)[N / 2], Elem a,
                                                    uint32_t tile_b) {
  if constexpr (kSliceWait) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t f[kSplit][4];
      split_slice(a, kk, f);
      fence_operand(d);
      wgmma_fence();
      const uint64_t desc = mnmajor_desc(tile_b, kk);
#pragma unroll
      for (int term = 0; term < kSplit; ++term)
        wgmma_rs_tb<N>(d, f[term], desc);
      wgmma_commit();
      wgmma_wait_all();
      fence_fragments(f);
      fence_operand(d);
    }
  } else {
    uint32_t f[4][kSplit][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) split_slice(a, kk, f[kk]);
    fence_operand(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t desc = mnmajor_desc(tile_b, kk);
#pragma unroll
      for (int term = 0; term < kSplit; ++term)
        wgmma_rs_tb<N>(d, f[kk][term], desc);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_fragments(f[kk]);
    fence_operand(d);
  }
}

// D[64 x 64] = A B^T for two K-major [64, K] tiles (K / 16 wgmmas),
// committed and waited for.
template <int K>
__device__ __forceinline__ void wgmma_kmajor_product(float (&d)[32],
                                                     uint32_t tile_a,
                                                     uint32_t tile_b) {
  fence_operand(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_ss_n64(d, kmajor_desc(tile_a, kk), kmajor_desc(tile_b, kk),
                 kk > 0 ? 1 : 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_operand(d);
}

// ------------------------------------------------------------ term pairs
// The float32-operand products of the wgmma_f32 kernels. Each float32
// operand enters as its kSplit bf16 terms: the resident operand's as
// consecutive [64, D] tiles (term a at ta + a * 64 * D * 2), the streamed
// operand's one term tile at a time (term j at tb), and a float32 matrix a
// kernel makes as register fragments split by split_slice. A product keeps
// the term pairs a + j <= 2 (six of nine): the dropped pairs are of order
// 2^-24 |x| |y|, float32's own rounding.
//
// Order. The tensor cores' float32 accumulation truncates each partial sum
// to the accumulator's magnitude, so every product added to a large
// accumulator loses up to an ulp of it. Where a product cancels (dP against
// Delta in the backward: a row that sees few keys gives dP - Delta near 0),
// adding the five small pairs after the main one cost up to 48 such ulps,
// more than the reference's atol (2e-5) on dS, and the backward's tests
// failed at rows that see one to three keys. The backward kernels therefore
// stream the terms j = 2, 1, 0, and every product issues a = 2 - j down to
// 0: the small pairs accumulate first, at their own magnitude, and only the
// main pair's D / 16 steps see the full one. The forward keeps the order it
// was measured with (kSmallFirst = false: j = 0, 1, 2 and a = 0 up), which
// holds the reference's forward tolerance at half its limit.

// Issue S (+)= sum over a <= 2 - j of A_a B_j^T (K-major [64, D] tiles,
// m64n64k16 wgmmas), the largest a first (kSmallFirst) or a = 0 first;
// with `first` the first product overwrites S. Neither fences nor waits.
template <int D, bool kSmallFirst = true>
__device__ __forceinline__ void issue_terms_abt(float (&s)[32], uint32_t ta,
                                                uint32_t tb, int j,
                                                bool first) {
  constexpr uint32_t kTile = 64 * D * 2;
#pragma unroll
  for (int i = 0; i < kSplit; ++i) {
    const int a = kSmallFirst ? kSplit - 1 - i : i;
    if (a + j >= kSplit) continue;
    const int a_first = kSmallFirst ? kSplit - 1 - j : 0;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, kmajor_desc(ta + a * kTile, kk), kmajor_desc(tb, kk),
                   !(first && a == a_first && kk == 0));
  }
}

// Issue O += sum over a <= 2 - j of F_a B_j over the 16-column slices
// K0 .. K0 + NK - 1 of F, whose terms are A fragments (f[i][a]: term a of
// slice K0 + i), B_j the transposed (MN-major) [64, D] term tile at tb.
// Neither fences nor waits.
template <int D, int K0 = 0, int NK = 4, bool kSmallFirst = true>
__device__ __forceinline__ void issue_terms_fb(
    float (&o)[D / 2], const uint32_t (&f)[NK][kSplit][4], uint32_t tb,
    int j) {
#pragma unroll
  for (int i = 0; i < NK; ++i) {
    const uint64_t desc = mnmajor_desc(tb, K0 + i);
#pragma unroll
    for (int n = 0; n < kSplit; ++n) {
      const int a = kSmallFirst ? kSplit - 1 - n : n;
      if (a + j < kSplit) wgmma_rs_tb<D>(o, f[i][a], desc);
    }
  }
}

// Keep the fragments of the terms a <= 2 - j live (and unchanged) until the
// wgmmas that read them have been waited for (see fence_fragments).
template <int NK>
__device__ __forceinline__ void fence_terms(uint32_t (&f)[NK][kSplit][4],
                                            int j) {
#pragma unroll
  for (int i = 0; i < NK; ++i)
#pragma unroll
    for (int a = 0; a < kSplit; ++a)
      if (a + j < kSplit)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          asm volatile("" : "+r"(f[i][a][r])::"memory");
}

// issue_terms_abt, committed and waited for.
template <int D, bool kSmallFirst = true>
__device__ __forceinline__ void terms_abt(float (&s)[32], uint32_t ta,
                                          uint32_t tb, int j, bool first) {
  fence_operand(s);
  wgmma_fence();
  issue_terms_abt<D, kSmallFirst>(s, ta, tb, j, first);
  wgmma_commit();
  wgmma_wait_all();
  fence_operand(s);
}

// issue_terms_fb over all four slices, committed and waited for.
template <int D, bool kSmallFirst = true>
__device__ __forceinline__ void terms_fb(float (&o)[D / 2],
                                         uint32_t (&f)[4][kSplit][4],
                                         uint32_t tb, int j) {
  fence_operand(o);
  wgmma_fence();
  issue_terms_fb<D, 0, 4, kSmallFirst>(o, f, tb, j);
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) fence_fragments(f[kk]);
  fence_operand(o);
}

// The A fragments f[i][a] of the 16-column slices K0 .. K0 + NK - 1 of a
// float32 64 x 64 matrix whose element i is `a(i)` (split_slice per slice).
template <int K0 = 0, int NK = 4, typename Elem>
__device__ __forceinline__ void split_all(Elem a,
                                          uint32_t (&f)[NK][kSplit][4]) {
#pragma unroll
  for (int i = 0; i < NK; ++i) split_slice(a, K0 + i, f[i]);
}

// ------------------------------------------------------------ host side
// The geometry of one [B, H, L, D] bf16 operand as the Python wrapper
// computes it (`tma_geometry`): 4 dims (D first, then the outer dims in
// stride order), 3 byte strides of dims 1..3, the 4 box extents and the
// map positions of the row, head and batch dims: 14 values.
constexpr int kGeoWords = 14;

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up once through the
// runtime (so the library needs no -lcuda at link time).
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p)
                                            : nullptr;
  }();
  return fn;
}

// Encode the tensor map of `ptr` from its 14 geometry words, and the
// coordinate positions the kernel needs. Returns cudaErrorInvalidValue if
// cuTensorMapEncodeTiled refuses it.
inline cudaError_t encode_tensor_map(CUtensorMap* map, TmaPos* pos,
                                     const void* ptr,
                                     const unsigned long long* geo) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    dims[i] = geo[i];
    box[i] = static_cast<cuuint32_t>(geo[7 + i]);
  }
  for (int i = 0; i < 3; ++i) strides[i] = geo[4 + i];
  pos->row = static_cast<int>(geo[11]);
  pos->head = static_cast<int>(geo[12]);
  pos->batch = static_cast<int>(geo[13]);
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The opt-in above 48 KB of dynamic shared memory, once per device.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, unsigned& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (bit != 0u && (__atomic_load_n(&done, __ATOMIC_ACQUIRE) & bit))
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) __atomic_fetch_or(&done, bit, __ATOMIC_RELEASE);
  return err;
}

}  // namespace pt_sm90

#ifdef PT_SM90_SELFCHECK
// ------------------------------------------------------------ self-check
// One warpgroup, one 64 x 64 x D product in each descriptor form, through
// the same TMA loads, descriptors and wgmma calls as the attention kernels:
//   c1 [64, 64] = A B^T        (SS, both tiles K-major, k = D)
//   c2 [64, D]  = A[:, :64] B  (RS: A fragments read from global memory,
//                               B the transposed MN-major tile, k = 64)
// for contiguous bf16 A, B of [64, D]; c1 and c2 float32, contiguous.
namespace pt_sm90 {

template <int D>
__global__ void __launch_bounds__(128, 1)
sm90_selfcheck_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b, TmaPos pos_a,
                      TmaPos pos_b, const __nv_bfloat16* __restrict__ a,
                      float* __restrict__ c1, float* __restrict__ c2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t tile_a = base, tile_b = base + D * 128;
  const uint32_t bar = base + 2 * D * 128;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(bar, 2 * D * 128);
    tma_load_tile<D>(tile_a, &map_a, bar, 0, 0, 0, pos_a);
    tma_load_tile<D>(tile_b, &map_b, bar, 0, 0, 0, pos_b);
  }
  mbar_wait(bar, 0);

  const int w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const int r0 = 16 * w + g, r1 = r0 + 8;

  float d1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d1[i] = 0.f;
  fence_operand(d1);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < D / 16; ++k)
    wgmma_ss_n64(d1, kmajor_desc(tile_a, k), kmajor_desc(tile_b, k), 1);
  wgmma_commit();
  wgmma_wait_all();
  fence_operand(d1);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      c1[(e < 2 ? r0 : r1) * 64 + 8 * j + 2 * t + (e & 1)] = d1[4 * j + e];

  uint32_t frag[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = 16 * kk + 2 * t;
    frag[kk][0] = *reinterpret_cast<const uint32_t*>(a + r0 * D + c);
    frag[kk][1] = *reinterpret_cast<const uint32_t*>(a + r1 * D + c);
    frag[kk][2] = *reinterpret_cast<const uint32_t*>(a + r0 * D + c + 8);
    frag[kk][3] = *reinterpret_cast<const uint32_t*>(a + r1 * D + c + 8);
  }
  float d2[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) d2[i] = 0.f;
  fence_operand(d2);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_tb<D>(d2, frag[kk], mnmajor_desc(tile_b, kk));
  wgmma_commit();
  wgmma_wait_all();
  fence_fragments(frag);
  fence_operand(d2);
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      c2[(e < 2 ? r0 : r1) * D + 8 * j + 2 * t + (e & 1)] = d2[4 * j + e];
}

template <int D>
inline cudaError_t launch_selfcheck(const void* a, const void* b,
                                    const unsigned long long* geo_a,
                                    const unsigned long long* geo_b, float* c1,
                                    float* c2, cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  TmaPos pos_a, pos_b;
  cudaError_t err = encode_tensor_map(&map_a, &pos_a, a, geo_a);
  if (err == cudaSuccess) err = encode_tensor_map(&map_b, &pos_b, b, geo_b);
  if (err != cudaSuccess) return err;
  // above 48 KB at D = 256: the opt-in first
  const size_t smem = 2 * D * 128 + 8 + 1024;
  static unsigned smem_set = 0;
  err = allow_smem(sm90_selfcheck_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  sm90_selfcheck_kernel<D><<<1, 128, smem, stream>>>(
      map_a, map_b, pos_a, pos_b, static_cast<const __nv_bfloat16*>(a), c1,
      c2);
  return cudaGetLastError();
}

}  // namespace pt_sm90

// The descriptor self-check above for D = 64, 128 or 256: a and b contiguous
// bf16 [64, D] (16-byte aligned), geo_a / geo_b their 14 tensor-map
// geometry words, c1 float32 [64, 64], c2 float32 [64, D]. Returns the
// launch's cudaError_t.
extern "C" int pt_sm90_selfcheck(const void* a, const void* b,
                                 const unsigned long long* geo_a,
                                 const unsigned long long* geo_b, void* c1,
                                 void* c2, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* f1 = static_cast<float*>(c1);
  float* f2 = static_cast<float*>(c2);
  if (D == 64)
    return (int)pt_sm90::launch_selfcheck<64>(a, b, geo_a, geo_b, f1, f2, s);
  if (D == 128)
    return (int)pt_sm90::launch_selfcheck<128>(a, b, geo_a, geo_b, f1, f2, s);
  if (D == 256)
    return (int)pt_sm90::launch_selfcheck<256>(a, b, geo_a, geo_b, f1, f2, s);
  return (int)cudaErrorInvalidValue;
}
#endif  // PT_SM90_SELFCHECK
