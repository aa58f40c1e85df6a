// bf16 tensor-core building blocks for Hopper (sm_90a), shared by
// flash_fwd.cu and flash_bwd.cu: cp.async copies that zero-fill what they do
// not read, ldmatrix operand loads, mma.sync m16n8k16 (bf16 in, fp32 sums),
// the hi + lo bf16 split of an fp32 operand, and the 16-byte-chunk swizzle of a [64][D] bf16 tile in shared memory
// (D = 64, 80 or 128).
// ops/_build.py hashes every csrc/*.cuh into each library's name, so an
// edit here rebuilds both kernels.
//
// Fragment layouts of m16n8k16 (lane = 4 g + t): A (16 x 16, row major)
// holds rows g and g + 8 at k = 2t, 2t + 1 and 2t + 8, 2t + 9; B (16 x 8)
// holds k = 2t, 2t + 1 (and + 8) at column g; the fp32 accumulator holds
// rows g and g + 8 at columns 2t, 2t + 1. So an accumulator tile over 16
// columns, packed to bf16 pairs, is the A fragment of a product over those
// 16 columns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) unless `valid`.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0));
}
// 4 bytes global -> shared; zero-filled unless `valid`.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// (x0, x1) as two bf16 pairs: hi = bf16(x), lo = bf16(x - hi), which carry
// ~16 bits of x where one bf16 rounding carries 8.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// The hi and lo A fragments of 16 columns (accumulator tiles 2kk, 2kk + 1).
template <int N>
__device__ __forceinline__ void split_frag(const float (&x)[N][4], int kk, uint32_t hi[4], uint32_t lo[4]) {
  split_bf16(x[2 * kk][0], x[2 * kk][1], hi[0], lo[0]);
  split_bf16(x[2 * kk][2], x[2 * kk][3], hi[1], lo[1]);
  split_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[2], lo[2]);
  split_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[3], lo[3]);
}

// Byte offset of 16-byte chunk `c` of row `r` in a [64][D] bf16 tile. Each
// whole group of 8 chunks XORs the chunk index with r % 8, so the 8 rows an
// ldmatrix phase reads at one chunk land on 8 different bank groups. At
// D = 80 a row holds 10 chunks: XOR with r % 8 would send chunks 8-9 to
// 8-15, past the row, so those two XOR with bit 2 of r instead (rows 0-3
// keep them, rows 4-7 swap them), which the 160-byte row stride spreads over
// the 8 bank groups as well. D = 64 and 128 keep the plain XOR.
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  static_assert(CH % 8 == 0 || CH % 8 == 2, "swz: a row's chunk count must be 8k or 8k + 2");
  if constexpr (CH % 8 == 0) {
    return (uint32_t)(r * (D * 2) + ((c ^ (r & 7)) << 4));
  } else {
    const int cs = c < (CH & ~7) ? c ^ (r & 7) : c ^ ((r >> 2) & 1);
    return (uint32_t)(r * (D * 2) + (cs << 4));
  }
}

// cp.async 64 rows of D bf16 into a swizzled tile, by a block of NT threads:
// row r from src + (row0 + r) * stride, zero-filled where row0 + r >= n_valid.
template <int D, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* __restrict__ src, long stride, int row0,
                                          int n_valid) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int j = 0; j < 64 * CH / NT; ++j) {
    const int i = threadIdx.x + j * NT;
    const int r = i / CH, c = i % CH;
    const bool ok = row0 + r < n_valid;
    cp_async16(dst + swz<D>(r, c), src + (long)(ok ? row0 + r : 0) * stride + c * 8, ok);
  }
}

}  // namespace
