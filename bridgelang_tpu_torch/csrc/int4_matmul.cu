// Packed-int4 weight matmuls for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU kernels of bridgelang_tpu/ops/int4_matmul.py
// (both launched from `_int4_2d`):
//   int4_mm_a8  <- `_kernel_a8` (w4a8): int8 activations q [M, K] x packed
//                  int4 weights -> f32 [M, N] without the per-token scale, or,
//                  given the per-row scales xs, (acc * xs[m]) in bf16 or f32
//                  (the w4a8 route's epilogue). Exact int32 sums per
//                  quantization group on the int8 tensor cores.
//   int4_mm     <- `_kernel` (float activations): x [M, K] in bf16 (bf16
//                  tensor cores, fp32 sums: wgmma at M > 64, mma.sync
//                  m16n8k16 at M <= 64) or in fp32 (the FMA units) -> x's
//                  dtype.
// and one helper of the w4a8 route, no TPU kernel's counterpart (XLA fuses it
// into the jitted program there):
//   quantize_a8 <- ops/quant.py `quantize_activations_per_token`: per row,
//                  scale = absmax / 127 (1 for a zero row) and q = rint(x / scale);
//                  absmax is the row's own, or one given per row (a row-parallel
//                  product's K shard quantized with the whole row's absmax).
//
// Weights: the JAX package's `out-paired-lobias/v2` bytes, packed [K, N/2]
// int8: byte [r, c] holds code[r, c] + 8 in the low nibble and
// code[r, N/2 + c] (signed) in the high nibble. Scales: bf16 [K/group, N],
// one per (group of `group` input rows, output column); `group` is a multiple
// of 128 that divides K (128, 256, 512). x is contiguous; packed, scales and
// out have unit column stride and row strides ldp, lds, ldo (elements), so a
// column block of a wider shard-blocked pack is read and written in place.
// N/2 a multiple of 64 (7B: 2048 and 5504 = 64 x 86; a 2-shard w_gate block:
// 2752); M of any size (ragged rows are zero-filled on load and not stored).
//
// What is computed is the TPU kernel's function, not its block structure.
// The TPU kernel runs two dots over the raw and the masked bytes because its
// compiler has no int8 vector bitwise ops; here a nibble unpacks in registers
// (lo = (b & 0xF) - 8 for column c, hi = b >> 4 for column N/2 + c) and one
// staged byte tile feeds both output halves. Per group the sums are
//   a8:   y = sum_r q[m, r] * code[r, n]  (int32, exact: the TPU's y_lo, y_hi)
//   f32:  y = sum_r x[m, r] * code[r, n]  (fp32)
// and then acc[m, n] = acc + float(y) * float(scale[group, n]), groups in
// order 0, 1, ..., with the product and the add rounded separately (no FMA),
// which is what the plain versions in ops/int4_matmul.py do. So the a8 kernels
// equal their plain version bit for bit; the float kernels differ from theirs
// only in the fp32 order of each group's dot.
//
// The int8 operand of the a8 kernels needs 4 consecutive k of one output
// column per 32-bit register, and the packed bytes hold 4 columns of one k.
// ldmatrix.trans of the staged bytes, read as b16, hands lane (g, t) bytes 2g
// and 2g + 1 of rows 2t and 2t + 1 of each 8 x 16-byte matrix; the row
// addresses it is given are free, so matrix 0 gets packed rows 4i, 4i + 1 and
// matrix 1 rows 4i + 2, 4i + 3 (i = 0..3), and two __byte_perm put k = 4t ..
// 4t + 3 of columns 2g and 2g + 1 into one register each: the s8 A fragment
// (mma.m16n8k32 and wgmma k32 alike) of 16 packed columns, with no byte
// transposes and no code planes in shared memory.
//
// Five designs, chosen by the launcher from the type and M:
//
// a8 at M <= 16 (decode; M = 1 per batch-1 token): bound by the bytes of the
// weights (w_gate: 22.5 MB + 0.7 MB of scales, ~6.9 us at 3.35 TB/s), so it
// streams them once over many blocks: split-K in whole quantization groups
// (each block owns 64 packed columns x `gps` groups; by default enough splits
// for >= 660 blocks, 5 per SM: 688-1,024 at the 7B shapes) through a 4-stage
// cp.async ring of 64 packed rows (16-byte coalesced copies) and the
// activation rows. Warp w computes packed columns 16w .. 16w + 15: mma.sync
// m16n8k32 s8 with the codes as A and q as B (15 of 16 rows wasted at M = 1,
// free against the byte bound). A
// block writes each of its groups' products float(y) * s into the fp32
// workspace [n_groups, M, N]; the last block of a column tile to finish (a
// per-tile counter after __threadfence) folds all groups in order, writes
// the output and resets the counter. Deterministic: no float atomics.
//
// a8 at M > 16 (prefill; M = 352 per predict): wgmma m64n64k32 s32.s8.s8,
// the product transposed (out^T = W^T q^T) as int4_mm's bf16 wgmma kernel: a
// block owns 64 packed columns x 64 activation rows (grids of >= 192 blocks at
// the 7B shapes, M = 352); warpgroup 0 computes the low-nibble columns,
// warpgroup 1 the high-nibble ones; A is 16 x the codes in registers from the
// fragments above (three ALU ops per register), B the int8 activation tile,
// K-major in the 128-byte swizzle (q's rows as they lie: 128 k per 128-byte
// row). A 4-stage cp.async ring runs 2 stages ahead. At group 128 a stage is
// a group, and the groups' int32 sums alternate between two accumulator sets:
// a group folds into the fp32 result, in group order, while the next group's
// wgmma run. At groups of 256 and 512, one set is drained and folded at each
// group's end.
//
// bf16 at M > 64 (QLoRA: M = 16 x 352 = 5632): wgmma with the weights in
// registers. The product runs transposed, out^T = W^T x^T: a block owns 64
// packed columns (128 outputs) x 128 activation rows; warpgroup 0 computes
// the 64 low-nibble columns, warpgroup 1 the 64 high-nibble ones, each as
// wgmma m64n128k16 whose A operand (64 output columns x 16 k) is dequantized
// in registers and whose B operand is the activation tile in shared memory.
// ldmatrix.trans of the packed bytes, read as b16, hands lane (g, t) bytes 2g
// and 2g+1 of a 16-byte row for k = 2t and 2t+1, which is the A fragment of
// two output columns after a shift, a mask and an OR with bf16 128 (0x4300 |
// v = 128 + v, exact) and one bf16 subtract: no byte transposes and no code
// planes in shared memory. A 5-stage cp.async ring (activations [128][64]
// in the 128-byte-swizzled K-major layout wgmma reads, packed bytes [64][64])
// runs 3 stages ahead of the products; a stage's A fragments are built while
// the previous stage's wgmma run. Each group's sums land in one accumulator
// set (the group's first wgmma overwrites it) and fold into a second in group
// order after the group's wgmma complete.
// Bound: 2 M K N operations, 0.51 ms for w_gate at the 989 TFLOP/s bf16
// peak; the kernel runs at ~37 % of it (PERF.md). Tried and not kept: a
// producer warp feeding the ring by TMA with mbarriers (slower here), and 256
// output columns per block with one accumulator rescaled at each group's end
// (barely faster, for extra roundings and zero-scale masking). A build
// without the global loads ran markedly faster, so more reuse per staged
// byte comes next; persistent blocks are not done either.
//
// bf16 at M <= 64: mma.sync m16n8k16 from planes in shared memory. A block
// computes BM rows x 64 packed columns; the K loop stages 64 input rows at a
// time: the activation tile as is, the weight tile unpacked into two
// K-contiguous code planes with 4 x 4 byte transposes (__byte_perm), so that
// each B fragment is one 32-bit shared load. Warps are 2 along N and 1, 2 or
// 4 along M.
//
// fp32: the FMA units (no TF32 and no bf16 rounding of x, as the JAX
// kernel's dot promotes f32 x bf16 to f32), for the card-vs-CPU parity run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

using bf16 = __nv_bfloat16;
constexpr int BK = 64;   // input rows staged per step of the bf16 kernels; divides every group
constexpr int BN2 = 64;  // packed columns per block

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// PTX wrappers (tests/cuda_emu/cuda_emu.h emulates each of this block).
// 16 bytes global -> shared; zero-filled (nothing read) unless `valid`.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins the accumulators after a wait, so no read of them moves above it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
// D[64 x 128] (+)= A[64 x 16] (registers, the mma.m16n8k16 A layout per
// warp) x B[16 x 128] (shared, K-major); scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n128k16(float d[64], const uint32_t a[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
// D[64 x 64] int32 (+)= A[64 x 32] s8 (registers, the mma.m16n8k32 A layout
// per warp) x B[32 x 64] s8 (shared, K-major); scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n64k32_s8(int d[32], const uint32_t a[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t ld32(const void* p) { return *reinterpret_cast<const uint32_t*>(p); }

// Shared-memory matrix descriptor of a K-major, 128-byte-swizzled tile whose
// rows are 128 bytes: start address, leading offset 1 (unused when
// swizzled), stride 1024 bytes between 8-row groups, swizzle mode 1.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// Byte offset of chunk c (of 8) of row r in a 1024-aligned tile of 128-byte
// rows (the canonical 128-byte swizzle wgmma reads). Eight rows read at one
// chunk by ldmatrix land in 8 distinct bank groups.
__device__ __forceinline__ uint32_t x_off(int r, int c) { return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4)); }

// Rows r0..r3 hold 4 bytes each (4 columns); out[j] holds column j's 4 bytes,
// row 0 in the low byte.
__device__ __forceinline__ void transpose4x4(uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3,
                                             uint32_t out[4]) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r0, r1, 0x7362);
  const uint32_t t2 = __byte_perm(r2, r3, 0x5140), t3 = __byte_perm(r2, r3, 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);
  out[1] = __byte_perm(t0, t2, 0x7632);
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

// Four packed bytes -> each byte's code + 8 (0..15): low nibbles as stored,
// high nibbles with the sign bit flipped.
__device__ __forceinline__ uint32_t lo_biased(uint32_t w) { return w & 0x0F0F0F0Fu; }
__device__ __forceinline__ uint32_t hi_biased(uint32_t w) { return ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u; }

// Biased bytes v (0..15) -> int8 codes v - 8, four at once (no carry crosses
// a byte: v + 0x78 <= 0x87).
__device__ __forceinline__ uint32_t codes_s8(uint32_t v) { return (v + 0x78787878u) ^ 0x80808080u; }

// Biased bytes v -> bf16 codes v - 8: 0x4300 | v is bf16 128 + v exactly;
// subtracting 136 is exact. Returns bytes 0-1 in .x, bytes 2-3 in .y.
__device__ __forceinline__ uint2 codes_bf16(uint32_t v) {
  const __nv_bfloat162 bias = __floats2bfloat162_rn(136.0f, 136.0f);
  uint32_t p0 = __byte_perm(v, 0x43434343u, 0x4140), p1 = __byte_perm(v, 0x43434343u, 0x4342);
  __nv_bfloat162 c0 = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&p0), bias);
  __nv_bfloat162 c1 = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&p1), bias);
  return make_uint2(*reinterpret_cast<uint32_t*>(&c0), *reinterpret_cast<uint32_t*>(&c1));
}

// acc += float(y) * s, product and sum rounded separately (the plain order).
__device__ __forceinline__ float fold(float acc, float y, float s) { return __fadd_rn(acc, __fmul_rn(y, s)); }

// --- bf16 activations at M <= 64: mma.sync from code planes ------------------------

// Stage packed rows k0..k0+63, columns n0..n0+63 into K-contiguous bf16 code
// planes: plane[col * SW + k].
template <int NT, int SW>
__device__ __forceinline__ void stage_weights(bf16* wlo, bf16* whi, const uint8_t* __restrict__ packed, int ldp,
                                              int k0, int n0) {
  for (int i = threadIdx.x; i < (BK / 4) * (BN2 / 16); i += NT) {
    const int kq = i / (BN2 / 16), c16 = i % (BN2 / 16);
    const uint8_t* src = packed + (long)(k0 + 4 * kq) * ldp + n0 + 16 * c16;
    uint4 rows[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) rows[r] = *reinterpret_cast<const uint4*>(src + (long)r * ldp);
#pragma unroll
    for (int q4 = 0; q4 < 4; ++q4) {
      uint32_t cols[4];
      transpose4x4(reinterpret_cast<const uint32_t*>(&rows[0])[q4], reinterpret_cast<const uint32_t*>(&rows[1])[q4],
                   reinterpret_cast<const uint32_t*>(&rows[2])[q4], reinterpret_cast<const uint32_t*>(&rows[3])[q4],
                   cols);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 16 * c16 + 4 * q4 + j;
        *reinterpret_cast<uint2*>(wlo + col * SW + 4 * kq) = codes_bf16(lo_biased(cols[j]));
        *reinterpret_cast<uint2*>(whi + col * SW + 4 * kq) = codes_bf16(hi_biased(cols[j]));
      }
    }
  }
}

// Stage activation rows m0..m0+BM-1, columns k0..k0+63 (rows past M zero).
template <int NT, int BM, int SX>
__device__ __forceinline__ void stage_x(bf16* xs, const bf16* __restrict__ x, int M, int K, int m0, int k0) {
  constexpr int V = 8;  // elements per 16-byte load
  for (int i = threadIdx.x; i < BM * (BK / V); i += NT) {
    const int r = i / (BK / V), c = (i % (BK / V)) * V;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (m0 + r < M) v = *reinterpret_cast<const uint4*>(x + (long)(m0 + r) * K + k0 + c);
    *reinterpret_cast<uint4*>(xs + r * SX + c) = v;
  }
}

// bf16 x [M, K] -> bf16 out, fp32 partial sums per group.
template <int WARPS_M, int MT>
__global__ void __launch_bounds__(WARPS_M * 64)
int4_mm_tc_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ packed,
                  const bf16* __restrict__ scales, bf16* __restrict__ out, int M, int K, int N2,
                  int group, int ldp, int lds, int ldo) {
  constexpr int NT = WARPS_M * 64;
  constexpr int BM = WARPS_M * MT * 16;
  constexpr int SX = BK + 8, SW = BK + 8;  // 16 bytes of padding per staged row
  __shared__ __align__(16) bf16 xs[BM * SX];
  __shared__ __align__(16) bf16 wlo[BN2 * SW];
  __shared__ __align__(16) bf16 whi[BN2 * SW];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN2;

  float c_lo[MT][4][4], c_hi[MT][4][4];
  float acc_lo[MT][4][4], acc_hi[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c_lo[mt][j][e] = c_hi[mt][j][e] = 0.0f, acc_lo[mt][j][e] = acc_hi[mt][j][e] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // the previous step's fragments are read
    stage_x<NT, BM, SX>(xs, x, M, K, m0, k0);
    stage_weights<NT, SW>(wlo, whi, packed, ldp, k0, n0);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const bf16* row = xs + (wm * MT * 16 + mt * 16 + g) * SX + ks + 2 * t;
        a[mt][0] = ld32(row);
        a[mt][1] = ld32(row + 8 * SX);
        a[mt][2] = ld32(row + 8);
        a[mt][3] = ld32(row + 8 * SX + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn * 32 + j * 8 + g;
        const uint32_t bl0 = ld32(wlo + n * SW + ks + 2 * t), bl1 = ld32(wlo + n * SW + ks + 8 + 2 * t);
        const uint32_t bh0 = ld32(whi + n * SW + ks + 2 * t), bh1 = ld32(whi + n * SW + ks + 8 + 2 * t);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(c_lo[mt][j], a[mt], bl0, bl1);
          mma_bf16(c_hi[mt][j], a[mt], bh0, bh1);
        }
      }
    }
    if ((k0 + BK) % group == 0) {  // the group ends: fold its sums, in group order
      const bf16* srow = scales + (long)((k0 + BK) / group - 1) * lds;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn * 32 + j * 8 + 2 * t;
        const float2 sl = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(srow + col));
        const float2 sh = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(srow + N2 + col));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc_lo[mt][j][e] = fold(acc_lo[mt][j][e], c_lo[mt][j][e], (e & 1) ? sl.y : sl.x);
            acc_hi[mt][j][e] = fold(acc_hi[mt][j][e], c_hi[mt][j][e], (e & 1) ? sh.y : sh.x);
            c_lo[mt][j][e] = c_hi[mt][j][e] = 0.0f;
          }
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn * 32 + j * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows g and g + 8
        const int row = m0 + wm * MT * 16 + mt * 16 + g + 8 * h;
        if (row >= M) continue;
        const long base = (long)row * ldo + col;
        *reinterpret_cast<__nv_bfloat162*>(out + base) =
            __floats2bfloat162_rn(acc_lo[mt][j][2 * h], acc_lo[mt][j][2 * h + 1]);
        *reinterpret_cast<__nv_bfloat162*>(out + base + N2) =
            __floats2bfloat162_rn(acc_hi[mt][j][2 * h], acc_hi[mt][j][2 * h + 1]);
      }
    }
  }
}

// --- bf16 activations at M > 64: wgmma with the weights in registers -----------------

namespace wg {

constexpr int BM = 128;     // activation rows per block: the wgmma N
constexpr int STAGES = 5;   // cp.async ring depth; loads run STAGES - 2 stages ahead
constexpr int NT = 256;     // two warpgroups: low-nibble and high-nibble output halves
constexpr int X_TILE = BM * BK * 2;  // [128][64] bf16, rows of 8 16-byte chunks
constexpr int W_TILE = BK * BN2;     // [64][64] packed bytes, rows of 4 16-byte chunks
constexpr int STAGE = X_TILE + W_TILE;  // 20 KB, a multiple of 1024: every activation tile stays 1024-aligned
constexpr size_t SMEM = (size_t)STAGES * STAGE + 1024;  // + slack to align the ring to 1024 bytes

// Swizzled byte offset of packed row k, chunk c of 4.
__device__ __forceinline__ uint32_t w_off(int k, int c) { return (uint32_t)(k * 64 + ((c ^ ((k >> 1) & 3)) << 4)); }

// One ring slot: activation rows m0.., columns k0..k0+63 (rows past M
// zero-filled, nothing read) and packed rows k0..k0+63, columns n0..n0+63.
__device__ __forceinline__ void load_stage(uint32_t slot, const bf16* __restrict__ x,
                                           const uint8_t* __restrict__ packed, int M, int K, int ldp, int m0,
                                           int n0, int k0) {
#pragma unroll
  for (int j = 0; j < BM * 8 / NT; ++j) {
    const int i = threadIdx.x + j * NT;
    const int r = i >> 3, c = i & 7;
    const bool ok = m0 + r < M;
    cp_async16(slot + x_off(r, c), x + (long)(ok ? m0 + r : 0) * K + k0 + c * 8, ok);
  }
  const int r = threadIdx.x >> 2, c = threadIdx.x & 3;  // 64 rows x 4 chunks: one per thread
  cp_async16(slot + X_TILE + w_off(r, c), packed + (long)(k0 + r) * ldp + n0 + c * 16, true);
}

// ldmatrix.trans of packed bytes read as b16 hands lane (g, t), for k = 2t
// and 2t+1, bytes 2g and 2g+1 of a 16-byte row: r = [k0 c_even, k0 c_odd,
// k1 c_even, k1 c_odd] (byte 0 lowest). dequant takes the nibble at bit `sh`
// of bytes 0 and 2 (sh 0 / 4: the even column's low / high nibble; 8 / 12:
// the odd column's) into a bf16 pair, k0 in the low half. The nibble lands in
// the mantissa of bf16 128 (0x4300 | v = 128 + v, exact); `kbits` 0x43084308
// also flips a high nibble's sign bit, which makes the signed code code + 8,
// as the low nibble stores it; subtracting 136 leaves the code, exactly.
__device__ __forceinline__ uint32_t dequant(uint32_t r, int sh, uint32_t kbits) {
  uint32_t v = ((r >> sh) & 0x000F000Fu) ^ kbits, bias = 0x43084308u;
  __nv_bfloat162 c = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v), *reinterpret_cast<__nv_bfloat162*>(&bias));
  return *reinterpret_cast<uint32_t*>(&c);
}

// The product computed transposed: out^T [N, M] = W^T [N, K] x^T [K, M]. A
// block computes 64 packed columns x 128 activation rows. Warpgroup 0 owns
// the 64 low-nibble output columns n0.., warpgroup 1 the 64 high-nibble ones
// N/2 + n0..; both read the same staged packed bytes and activations. Its
// warp w holds wgmma rows 16w..16w+15: row g is packed column n0 + 16w + 2g,
// row g + 8 is n0 + 16w + 2g + 1, because ldmatrix.trans of the packed bytes
// hands lane (g, t) bytes 2g and 2g+1 of a 16-byte row, for k = 2t and 2t+1:
// the A fragment dequantizes in registers from one ldmatrix, with no
// shuffle. The activation tile is wgmma's B operand, straight from the ring.
// Each group's sums land in `part` (the first wgmma of a group overwrites
// it) and fold into `acc` in group order, as the plain version does.
__global__ void __launch_bounds__(NT, 1)
int4_mm_bf16_wgmma_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
                          const __nv_bfloat16* __restrict__ scales, __nv_bfloat16* __restrict__ out, int M, int K,
                          int N2, int group, int ldp, int lds, int ldo) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const int hi = threadIdx.x / 128;  // warpgroup: 0 low nibbles, 1 high nibbles
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN2;
  const int nk = K / BK, gsteps = group / BK;
  const int sh_even = hi ? 4 : 0, sh_odd = hi ? 12 : 8;
  const uint32_t kbits = hi ? 0x43084308u : 0x43004300u;
  constexpr int P = STAGES - 2;

#pragma unroll
  for (int s = 0; s < P; ++s) {
    if (s < nk) load_stage(base + s * STAGE, x, packed, M, K, ldp, m0, n0, s * BK);
    cp_async_commit();
  }

  float part[64], acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = acc[i] = 0.0f;
  uint32_t a[2][4][4];  // [stage parity][k16 step][fragment register]
  const int col = n0 + 16 * warp + 2 * g;  // packed column of wgmma row g; row g + 8 is col + 1
  const __nv_bfloat16* scol = scales + (hi ? N2 : 0) + col;

  for (int s0 = 0; s0 < nk; s0 += 2) {  // K is a multiple of 128: stages come in pairs
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = s0 + h;
      cp_async_wait<P - 1>();
      fence_proxy_async();  // this thread's copies are visible to wgmma's reads
      __syncthreads();  // stage s has landed; both warpgroups are done with stage s - 2
      if (s + P < nk) load_stage(base + ((s + P) % STAGES) * STAGE, x, packed, M, K, ldp, m0, n0, (s + P) * BK);
      cp_async_commit();

      const uint32_t xs = base + (s % STAGES) * STAGE, ws = xs + X_TILE;
#pragma unroll
      for (int kp = 0; kp < 2; ++kp) {  // k16 steps 2kp and 2kp + 1: packed rows 32kp .. 32kp + 31
        uint32_t r[4];
        ldsm_x4_t(r, ws + w_off(32 * kp + 8 * (lane >> 3) + (lane & 7), warp));
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          a[h][2 * kp + j][0] = dequant(r[2 * j], sh_even, kbits);      // row g, k 2t, 2t+1
          a[h][2 * kp + j][1] = dequant(r[2 * j], sh_odd, kbits);       // row g + 8
          a[h][2 * kp + j][2] = dequant(r[2 * j + 1], sh_even, kbits);  // row g, k 2t + 8, 2t + 9
          a[h][2 * kp + j][3] = dequant(r[2 * j + 1], sh_odd, kbits);   // row g + 8
        }
      }
      wgmma_fence();
      const bool fresh = s % gsteps == 0;  // a group's first stage: its sums restart
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
        wgmma_m64n128k16(part, a[h][ks], desc_sw128(xs + 32 * ks), (fresh && ks == 0) ? 0 : 1);
      wgmma_commit();
      if ((s + 1) % gsteps == 0) {  // the group ends: fold its sums, in group order
        wgmma_wait<0>();
        fence_regs(part);
        const float2 sc = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(scol + (long)((s + 1) / gsteps - 1) * lds));
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = fold(acc[i], part[i], (i & 2) ? sc.y : sc.x);
      } else {
        wgmma_wait<1>();  // stage s - 1 is done: its A registers and ring slot may be reused
      }
    }
  }
  cp_async_wait<0>();

  // acc[4j + e]: wgmma row g (e < 2) or g + 8, activation row m0 + 8j + 2t + (e & 1).
  __nv_bfloat16* o = out + (hi ? N2 : 0) + col;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int row = m0 + 8 * j + 2 * t;
    if (row < M)
      *reinterpret_cast<__nv_bfloat162*>(o + (long)row * ldo) = __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 2]);
    if (row + 1 < M)
      *reinterpret_cast<__nv_bfloat162*>(o + (long)(row + 1) * ldo) =
          __floats2bfloat162_rn(acc[4 * j + 1], acc[4 * j + 3]);
  }
}

int launch(const void* x, const void* packed, const void* scales, void* out, int M, int K, int N2, int group, int ldp,
           int lds, int ldo, cudaStream_t st) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(int4_mm_bf16_wgmma_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid(N2 / BN2, cdiv(M, BM));
  int4_mm_bf16_wgmma_kernel<<<grid, NT, SMEM, st>>>(
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(packed), static_cast<const bf16*>(scales),
      static_cast<bf16*>(out), M, K, N2, group, ldp, lds, ldo);
  return (int)cudaGetLastError();
}

}  // namespace wg

// fp32 activations on the FMA units: a block computes 32 rows x 64 packed
// columns; thread (ty, tx) owns packed column tx (both output halves) for
// rows 8 ty .. 8 ty + 7 and sums each group's dot over k in order.
constexpr int F_BM = 32, F_BK = 32, F_NT = 256;

__global__ void __launch_bounds__(F_NT)
int4_mm_f32_kernel(const float* __restrict__ x, const uint8_t* __restrict__ packed,
                   const __nv_bfloat16* __restrict__ scales, float* __restrict__ out, int M, int K, int N2,
                   int group, int ldp, int lds, int ldo) {
  __shared__ __align__(16) float xs[F_BM][F_BK + 4];
  __shared__ __align__(16) uint8_t ws[F_BK][BN2];
  const int tx = threadIdx.x % BN2, ty = threadIdx.x / BN2;
  const int m0 = blockIdx.y * F_BM, n0 = blockIdx.x * BN2;
  float y_lo[8], y_hi[8], acc_lo[8], acc_hi[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) y_lo[r] = y_hi[r] = acc_lo[r] = acc_hi[r] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += F_BK) {
    __syncthreads();
    {
      const int r = threadIdx.x / (F_BK / 4), c = (threadIdx.x % (F_BK / 4)) * 4;  // 256 float4s
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + r < M) v = *reinterpret_cast<const float4*>(x + (long)(m0 + r) * K + k0 + c);
      *reinterpret_cast<float4*>(&xs[r][c]) = v;
    }
    if (threadIdx.x < F_BK * BN2 / 16) {
      const int r = threadIdx.x / (BN2 / 16), c = (threadIdx.x % (BN2 / 16)) * 16;
      *reinterpret_cast<uint4*>(&ws[r][c]) = *reinterpret_cast<const uint4*>(packed + (long)(k0 + r) * ldp + n0 + c);
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < F_BK; ++k) {
      const uint8_t b = ws[k][tx];
      const float lo = (float)((int)(b & 0xF) - 8);
      const float hi = (float)((int)(int8_t)b >> 4);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float xv = xs[ty * 8 + r][k];
        y_lo[r] = fmaf(xv, lo, y_lo[r]);
        y_hi[r] = fmaf(xv, hi, y_hi[r]);
      }
    }
    if ((k0 + F_BK) % group == 0) {
      const __nv_bfloat16* srow = scales + (long)((k0 + F_BK) / group - 1) * lds;
      const float sl = __bfloat162float(srow[n0 + tx]), sh = __bfloat162float(srow[N2 + n0 + tx]);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        acc_lo[r] = fold(acc_lo[r], y_lo[r], sl);
        acc_hi[r] = fold(acc_hi[r], y_hi[r], sh);
        y_lo[r] = y_hi[r] = 0.0f;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = m0 + ty * 8 + r;
    if (row < M) {
      out[(long)row * ldo + n0 + tx] = acc_lo[r];
      out[(long)row * ldo + N2 + n0 + tx] = acc_hi[r];
    }
  }
}

int launch_f32(const void* x, const void* packed, const void* scales, void* out, int M, int K, int N2, int group,
               int ldp, int lds, int ldo, cudaStream_t st) {
  const dim3 grid(N2 / BN2, cdiv(M, F_BM));
  int4_mm_f32_kernel<<<grid, F_NT, 0, st>>>(static_cast<const float*>(x), static_cast<const uint8_t*>(packed),
                                            static_cast<const bf16*>(scales), static_cast<float*>(out), M, K, N2,
                                            group, ldp, lds, ldo);
  return (int)cudaGetLastError();
}

template <int WARPS_M, int MT>
int launch_tc(const void* x, const void* packed, const void* scales, void* out, int M, int K, int N2, int group,
              int ldp, int lds, int ldo, cudaStream_t st) {
  constexpr int NT = WARPS_M * 64, BM = WARPS_M * MT * 16;
  const dim3 grid(N2 / BN2, cdiv(M, BM));
  int4_mm_tc_kernel<WARPS_M, MT><<<grid, NT, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(packed), static_cast<const bf16*>(scales),
      static_cast<bf16*>(out), M, K, N2, group, ldp, lds, ldo);
  return (int)cudaGetLastError();
}

// --- int8 activations (w4a8) ----------------------------------------------------------

// The a8 kernels' packed tile: rows of 64 bytes (4 16-byte chunks), chunk c
// of row k at k * 64 + ((c ^ ((k >> 2) & 3)) << 4). A fragment load reads the
// rows k = 4i + j (i = 0..3) of one j at one chunk per 8-lane phase; the XOR
// puts them in distinct bank groups.
__device__ __forceinline__ uint32_t a8_w_off(int k, int c) {
  return (uint32_t)(k * 64 + ((c ^ ((k >> 2) & 3)) << 4));
}

// The address lane `lane` hands ldmatrix.x4.trans for packed rows k0 ..
// k0 + 31 at chunk c: matrix i (lanes 8i .. 8i + 7) reads rows
// k0 + 16 (i >> 1) + 2 (i & 1) + {0, 1, 4, 5, 8, 9, 12, 13}, so that its rows
// 2t and 2t + 1, which .trans hands lane (g, t), are k = 4t + 2 (i & 1) and
// 4t + 2 (i & 1) + 1 (+ 16 for matrices 2 and 3).
__device__ __forceinline__ uint32_t a8_frag_addr(uint32_t tile, int k0, int c, int lane) {
  const int i = lane >> 3, r = lane & 7;
  return tile + a8_w_off(k0 + 16 * (i >> 1) + 4 * (r >> 1) + 2 * (i & 1) + (r & 1), c);
}

// From ldmatrix.x4.trans (r[i]: bytes 2g, 2g + 1 of two rows, see above) to
// the packed bytes of the s8 A fragment of 16 packed columns x 32 k: row g
// is column 2g of the chunk, row g + 8 column 2g + 1; w[0], w[1] hold k = 4t
// .. 4t + 3, w[2], w[3] k = 16 + 4t .. 19 + 4t, lowest k in the low byte.
__device__ __forceinline__ void a8_frag_bytes(const uint32_t r[4], uint32_t w[4]) {
  w[0] = __byte_perm(r[0], r[1], 0x6420);
  w[1] = __byte_perm(r[0], r[1], 0x7531);
  w[2] = __byte_perm(r[2], r[3], 0x6420);
  w[3] = __byte_perm(r[2], r[3], 0x7531);
}

// One a8 output, or two neighbouring columns: f32 acc as is when xs is null,
// else __fmul_rn(acc, xs[m]) in bf16 (out_bf16) or f32, which is what the
// plain route's (acc * xs).to(dtype) gives.
__device__ __forceinline__ void a8_store(void* out, const float* xs, int out_bf16, long at, int m, float v) {
  if (xs == nullptr) {
    static_cast<float*>(out)[at] = v;
    return;
  }
  v = __fmul_rn(v, xs[m]);
  if (out_bf16)
    static_cast<bf16*>(out)[at] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(out)[at] = v;
}
__device__ __forceinline__ void a8_store2(void* out, const float* xs, int out_bf16, long at, int m, float v0,
                                          float v1) {
  if (xs != nullptr) v0 = __fmul_rn(v0, xs[m]), v1 = __fmul_rn(v1, xs[m]);
  if (out_bf16)
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + at) = __floats2bfloat162_rn(v0, v1);
  else
    *reinterpret_cast<float2*>(static_cast<float*>(out) + at) = make_float2(v0, v1);
}

namespace dec {

constexpr int M_MAX = 16;        // the decode kernel's rows: two n8 tiles of mma
constexpr int NT = 128;          // 4 warps: warp w owns packed columns 16w .. 16w + 15 of the tile
constexpr int BK = 64;           // packed rows per ring stage
constexpr int STAGES = 4;        // cp.async ring depth: STAGES - 1 stages in flight
constexpr int QROW = 80;         // a staged activation row: 64 bytes + 16 (conflict-free B loads)
constexpr int W_TILE = BK * BN2;                  // 4096 bytes
constexpr int STAGE = W_TILE + M_MAX * QROW;      // + 16 activation rows
constexpr int SMEM = STAGES * STAGE;              // 21,504 bytes
constexpr int BLOCKS = 5 * 132;  // the auto split aims at >= this many blocks (5 per SM)

// One ring slot: packed rows k0 .. k0 + 63, columns n0 .. n0 + 63, and
// activation rows 0 .. qrows - 1 (zero past M), bytes k0 .. k0 + 63.
__device__ __forceinline__ void load_stage(uint32_t slot, const int8_t* __restrict__ q,
                                           const uint8_t* __restrict__ packed, int M, int K, int ldp, int n0, int k0,
                                           int qrows) {
#pragma unroll
  for (int j = 0; j < BK * 4 / NT; ++j) {
    const int i = threadIdx.x + j * NT, r = i >> 2, c = i & 3;
    cp_async16(slot + a8_w_off(r, c), packed + (long)(k0 + r) * ldp + n0 + 16 * c, true);
  }
  if (threadIdx.x < qrows * 4) {
    const int r = threadIdx.x >> 2, c = threadIdx.x & 3;
    const bool ok = r < M;
    cp_async16(slot + W_TILE + r * QROW + 16 * c, q + (long)(ok ? r : 0) * K + k0 + 16 * c, ok);
  }
}

}  // namespace dec

// a8 at M <= 16: split-K over whole groups. Block (x, y) owns packed columns
// 64x .. 64x + 63 and groups y gps .. min((y + 1) gps, n_groups) - 1. With
// NT8 n8 tiles (M <= 8 NT8 rows), each warp's 16 columns run as mma.sync
// m16n8k32 s8, the codes as A and q as B. Each group's products float(y) * s go to ws[group][m][col] (col over the 2
// N2 outputs); the tile's last block folds them in group order.
template <int NT8>
__global__ void __launch_bounds__(dec::NT)
int4_mm_a8_splitk_kernel(const int8_t* __restrict__ q, const uint8_t* __restrict__ packed,
                         const bf16* __restrict__ scales, const float* __restrict__ xs, void* __restrict__ out,
                         float* __restrict__ ws, int* __restrict__ counters, int M, int K, int N2, int group, int ldp,
                         int lds, int ldo, int out_bf16, int gps) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int is_last;
  const uint32_t base = smem_u32(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN2, N = 2 * N2;
  const int n_groups = K / group, gsteps = group / dec::BK;
  const int grp0 = blockIdx.y * gps, k_begin = grp0 * group;
  const int nk = (min(n_groups, grp0 + gps) - grp0) * gsteps;
  constexpr int P = dec::STAGES - 1;
  constexpr int QR = 8 * NT8;

#pragma unroll
  for (int s = 0; s < P; ++s) {
    if (s < nk) dec::load_stage(base + s * dec::STAGE, q, packed, M, K, ldp, n0, k_begin + s * dec::BK, QR);
    cp_async_commit();
  }

  int c_lo[NT8][4], c_hi[NT8][4];
#pragma unroll
  for (int j = 0; j < NT8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c_lo[j][e] = c_hi[j][e] = 0;
  const int col = n0 + 16 * warp + 2 * g;  // mma row g; row g + 8 is col + 1

  for (int s = 0; s < nk; ++s) {
    cp_async_wait<P - 1>();
    __syncthreads();  // stage s has landed; every warp is done with stage s - 1
    if (s + P < nk)
      dec::load_stage(base + ((s + P) % dec::STAGES) * dec::STAGE, q, packed, M, K, ldp, n0,
                      k_begin + (s + P) * dec::BK, QR);
    cp_async_commit();
    const uint32_t slot = base + (s % dec::STAGES) * dec::STAGE;
    const uint8_t* qs = smem + (s % dec::STAGES) * dec::STAGE + dec::W_TILE;
#pragma unroll
    for (int kk = 0; kk < dec::BK; kk += 32) {
      uint32_t r[4], w[4], alo[4], ahi[4];
      ldsm_x4_t(r, a8_frag_addr(slot, kk, warp, lane));
      a8_frag_bytes(r, w);
#pragma unroll
      for (int i = 0; i < 4; ++i) alo[i] = codes_s8(lo_biased(w[i])), ahi[i] = codes_s8(hi_biased(w[i]));
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        const uint8_t* qrow = qs + (8 * j + g) * dec::QROW + kk + 4 * t;
        const uint32_t b0 = ld32(qrow), b1 = ld32(qrow + 16);
        mma_s8(c_lo[j], alo, b0, b1);
        mma_s8(c_hi[j], ahi, b0, b1);
      }
    }
    if ((s + 1) % gsteps == 0) {  // the group ends: its products to the workspace
      const int grp = grp0 + (s + 1) / gsteps - 1;
      const bf16* srow = scales + (long)grp * lds + col;
      const float2 sl = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(srow));
      const float2 sh = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(srow + N2));
      float* wrow = ws + (long)grp * M * N + col;
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // c[e]: column col + (e >> 1), row 8j + 2t + (e & 1)
          const int m = 8 * j + 2 * t + (e & 1);
          if (m < M) {
            float* p = wrow + (long)m * N + (e >> 1);
            p[0] = __fmul_rn((float)c_lo[j][e], (e >> 1) ? sl.y : sl.x);
            p[N2] = __fmul_rn((float)c_hi[j][e], (e >> 1) ? sh.y : sh.x);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NT8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c_lo[j][e] = c_hi[j][e] = 0;
    }
  }
  cp_async_wait<0>();

  // The tile's last block folds every group's products in order (the
  // threadFenceReduction pattern: publish, count, and the last one reads).
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(counters + blockIdx.x, 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int i = threadIdx.x; i < M * 2 * BN2; i += dec::NT) {
    const int m = i / (2 * BN2), c = i % (2 * BN2);
    const int oc = n0 + c + (c < BN2 ? 0 : N2 - BN2);  // low-nibble columns, then the high ones
    const float* p = ws + (long)m * N + oc;
    float acc = 0.0f;
#pragma unroll 8
    for (int grp = 0; grp < n_groups; ++grp) acc = __fadd_rn(acc, __ldcg(p + (long)grp * M * N));
    a8_store(out, xs, out_bf16, (long)m * ldo + oc, m, acc);
  }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;  // ready for the next launch
}

namespace pf {

constexpr int BM = 64;       // activation rows per block: the wgmma N
constexpr int BK = 128;      // k per stage: one 128-byte row of the activation tile
constexpr int STAGES = 4;    // cp.async ring depth; loads run STAGES - 2 stages ahead
constexpr int NT = 256;      // warpgroup 0: low-nibble columns, 1: high-nibble columns
constexpr int X_TILE = BM * BK;       // [64][128] int8, 8 KB
constexpr int W_TILE = BK * BN2;      // [128][64] packed bytes, 8 KB
constexpr int STAGE = X_TILE + W_TILE;  // 16 KB: every activation tile stays 1024-aligned
constexpr size_t SMEM = (size_t)STAGES * STAGE + 1024;  // + slack to align the ring to 1024 bytes

__device__ __forceinline__ void load_stage(uint32_t slot, const int8_t* __restrict__ q,
                                           const uint8_t* __restrict__ packed, int M, int K, int ldp, int m0, int n0,
                                           int k0) {
#pragma unroll
  for (int j = 0; j < BM * 8 / NT; ++j) {  // 64 rows x 8 chunks
    const int i = threadIdx.x + j * NT, r = i >> 3, c = i & 7;
    const bool ok = m0 + r < M;
    cp_async16(slot + x_off(r, c), q + (long)(ok ? m0 + r : 0) * K + k0 + 16 * c, ok);
  }
#pragma unroll
  for (int j = 0; j < BK * 4 / NT; ++j) {  // 128 rows x 4 chunks
    const int i = threadIdx.x + j * NT, r = i >> 2, c = i & 3;
    cp_async16(slot + X_TILE + a8_w_off(r, c), packed + (long)(k0 + r) * ldp + n0 + 16 * c, true);
  }
}

}  // namespace pf

// Four packed bytes -> 16 x each byte's code as int8 (exact: codes are in
// [-8, 7]): the high nibble is the signed code in place; the low one, code +
// 8, shifted up with its top bit flipped. Two or three ops where the codes
// themselves take four; a group's sums are 16 y, and y = sum >> 4 exactly
// (|16 y| <= 16 x 127 x 8 x 512 < 2^31).
__device__ __forceinline__ uint32_t lo_x16(uint32_t w) { return ((w << 4) & 0xF0F0F0F0u) ^ 0x80808080u; }
__device__ __forceinline__ uint32_t hi_x16(uint32_t w) { return w & 0xF0F0F0F0u; }

// A stage's A fragments of one warp: 16 packed columns (chunk `warp`) x 128 k
// as four k32 slabs, the low (hi == 0) or high nibbles' 16 x codes.
__device__ __forceinline__ void a8_wgmma_frags(uint32_t (&a)[4][4], uint32_t w_tile, int warp, int lane, int hi) {
#pragma unroll
  for (int ks = 0; ks < pf::BK / 32; ++ks) {
    uint32_t r[4], w[4];
    ldsm_x4_t(r, a8_frag_addr(w_tile, 32 * ks, warp, lane));
    a8_frag_bytes(r, w);
#pragma unroll
    for (int i = 0; i < 4; ++i) a[ks][i] = hi ? hi_x16(w[i]) : lo_x16(w[i]);
  }
}

// A stage's four wgmma into d (the first overwrites d when `fresh`), committed
// as one group. The register fence first keeps every earlier read of d (a
// fold) above the wgmma's pipeline stage, so ptxas need not serialize them.
__device__ __forceinline__ void a8_wgmma_stage(int (&d)[32], const uint32_t (&a)[4][4], uint32_t x_tile, bool fresh) {
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < pf::BK / 32; ++ks)
    wgmma_m64n64k32_s8(d, a[ks], desc_sw128(x_tile + 32 * ks), (fresh && ks == 0) ? 0 : 1);
  wgmma_commit();
}

// The scales of wgmma rows g and g + 8 (packed columns col, col + 1) in one group.
__device__ __forceinline__ float2 a8_scales(const bf16* srow) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(srow));
}

// acc = acc + float(y) * s for one finished group (its sums d = 16 y); d[i]
// is wgmma row g (i & 2 == 0: scale .x) or g + 8 (.y).
__device__ __forceinline__ void a8_fold(float (&acc)[32], int (&d)[32], float2 sc) {
  fence_regs(d);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = fold(acc[i], (float)(d[i] >> 4), (i & 2) ? sc.y : sc.x);
}

// a8 at M > 16: out^T [N, M] = W^T [N, K] q^T [K, M] on wgmma. Warp w of
// warpgroup h holds wgmma rows 16w .. 16w + 15: row g is packed column
// n0 + 16w + 2g, row g + 8 is n0 + 16w + 2g + 1, of the low (h = 0) or high
// (h = 1) nibbles. G1 (group == 128, one stage per group, the serving pack):
// the groups' sums alternate between two accumulator sets, so a group folds
// while the next group's wgmma run (wait_group 1); else (group 256, 512) one
// set, drained and folded at each group's end.
template <bool G1>
__global__ void __launch_bounds__(pf::NT, 1)
int4_mm_a8_wgmma_kernel(const int8_t* __restrict__ q, const uint8_t* __restrict__ packed,
                        const bf16* __restrict__ scales, const float* __restrict__ xs, void* __restrict__ out, int M,
                        int K, int N2, int group, int ldp, int lds, int ldo, int out_bf16) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const int hi = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * pf::BM, n0 = blockIdx.x * BN2;
  const int nk = K / pf::BK, gsteps = group / pf::BK;
  constexpr int P = pf::STAGES - 2;

#pragma unroll
  for (int s = 0; s < P; ++s) {
    if (s < nk) pf::load_stage(base + s * pf::STAGE, q, packed, M, K, ldp, m0, n0, s * pf::BK);
    cp_async_commit();
  }

  int part[2][32];  // no initial value: a group's first wgmma overwrites its set
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  uint32_t a[2][4][4];  // [stage parity][k32 slab][fragment register]
  float2 sc[2];         // G1: the scales of the groups in part[0], part[1]; else sc[0]: the current group's
  const int col = n0 + 16 * warp + 2 * g;
  const bf16* scol = scales + (hi ? N2 : 0) + col;

  for (int s0 = 0; s0 < nk; s0 += 2) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = s0 + h;
      if (s == nk) break;  // an odd number of stages
      cp_async_wait<P - 1>();
      fence_proxy_async();  // this thread's copies are visible to wgmma's reads
      __syncthreads();  // stage s has landed; both warpgroups are done with stage s - 2
      if (s + P < nk)
        pf::load_stage(base + ((s + P) % pf::STAGES) * pf::STAGE, q, packed, M, K, ldp, m0, n0, (s + P) * pf::BK);
      cp_async_commit();
      const uint32_t x_tile = base + (s % pf::STAGES) * pf::STAGE;
      if (G1 || s % gsteps == 0) sc[G1 ? h : 0] = a8_scales(scol + (long)(s / gsteps) * lds);  // used a stage on
      a8_wgmma_frags(a[h], x_tile + pf::X_TILE, warp, lane, hi);
      if constexpr (G1) {
        a8_wgmma_stage(part[h], a[h], x_tile, true);
        wgmma_wait<1>();  // group s - 1 is done: fold it while group s runs
        if (s > 0) a8_fold(acc, part[h ^ 1], sc[h ^ 1]);
      } else {
        a8_wgmma_stage(part[0], a[h], x_tile, s % gsteps == 0);
        if ((s + 1) % gsteps == 0) {  // the group ends: fold its sums, in group order
          wgmma_wait<0>();
          a8_fold(acc, part[0], sc[0]);
        } else {
          wgmma_wait<1>();  // stage s - 1 is done: its A registers and ring slot may be reused
        }
      }
    }
  }
  if constexpr (G1) {  // the last group
    wgmma_wait<0>();
    if ((nk - 1) & 1)
      a8_fold(acc, part[1], sc[1]);
    else
      a8_fold(acc, part[0], sc[0]);
  }
  cp_async_wait<0>();

  // acc[4j + e]: wgmma row g (e < 2) or g + 8, activation row m0 + 8j + 2t + (e & 1).
  const int oc = (hi ? N2 : 0) + col;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * j + 2 * t + e;
      if (m < M) a8_store2(out, xs, out_bf16, (long)m * ldo + oc, m, acc[4 * j + e], acc[4 * j + 2 + e]);
    }
  }
}

// Per-row int8 quantization, one block per row: absmax in fp32, scale =
// absmax / 127 (1 where absmax is 0), q = rint(x / scale) (half to even, as
// torch.round), IEEE divisions: quantize_activations_per_token's bits. The
// absmax carries a NaN as torch.amax does (fmaxf would drop it), so a row
// holding one gets a NaN scale and NaN outputs on every route; its codes are
// float-to-int8 conversions of NaN, which the routes need not agree on.
constexpr int QZ_NT = 256;

__device__ __forceinline__ float nan_max(float a, float b) { return (b != b || b > a) ? b : a; }

__device__ __forceinline__ float qz_at(const void* x, int x_bf16, long i) {
  return x_bf16 ? __bfloat162float(static_cast<const bf16*>(x)[i]) : static_cast<const float*>(x)[i];
}

__global__ void __launch_bounds__(QZ_NT)
quantize_a8_kernel(const void* __restrict__ x, int x_bf16, const float* __restrict__ absmax, int8_t* __restrict__ q,
                   float* __restrict__ xs, int K) {
  __shared__ float warp_max[QZ_NT / 32];
  const long row = (long)blockIdx.x * K;
  float amax = 0.0f;
  if (absmax) {  // given: the whole row's, of which x holds a K shard
    amax = absmax[blockIdx.x];
  } else {
    for (int k = threadIdx.x; k < K; k += QZ_NT) amax = nan_max(amax, fabsf(qz_at(x, x_bf16, row + k)));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = amax;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < QZ_NT / 32; ++w) amax = nan_max(amax, warp_max[w]);
  }
  const float scale = amax == 0.0f ? 1.0f : __fdiv_rn(amax, 127.0f);
  if (threadIdx.x == 0) xs[blockIdx.x] = scale;
  for (int k = threadIdx.x; k < K; k += QZ_NT) q[row + k] = (int8_t)rintf(__fdiv_rn(qz_at(x, x_bf16, row + k), scale));
}

// Row strides: packed rows 16-byte aligned (ldp % 16), scale and output rows
// even (their paired loads and stores), none shorter than its row.
bool shapes_ok(int M, int K, int N2, int group, int ldp, int lds, int ldo) {
  return M > 0 && group > 0 && group % 128 == 0 && K % group == 0 && N2 > 0 && N2 % BN2 == 0 && ldp >= N2 &&
         ldp % 16 == 0 && lds >= 2 * N2 && lds % 2 == 0 && ldo >= 2 * N2 && ldo % 2 == 0;
}

// Groups per split-K block: `split_groups` when > 0, else enough splits for
// ~dec::BLOCKS blocks over the N2 / 64 column tiles.
int a8_split_groups(int K, int N2, int group, int split_groups) {
  const int n_groups = K / group, tiles = N2 / BN2;
  if (split_groups > 0) return std::min(split_groups, n_groups);
  return std::max(1, std::min(n_groups, tiles * n_groups / dec::BLOCKS));
}

template <int NT8>
int launch_a8_decode(const void* q, const void* packed, const void* scales, const float* xs, void* out, float* ws,
                     int* counters, int M, int K, int N2, int group, int ldp, int lds, int ldo, int out_bf16,
                     int gps, cudaStream_t st) {
  const dim3 grid(N2 / BN2, cdiv(K / group, gps));
  int4_mm_a8_splitk_kernel<NT8><<<grid, dec::NT, dec::SMEM, st>>>(
      static_cast<const int8_t*>(q), static_cast<const uint8_t*>(packed), static_cast<const bf16*>(scales), xs, out,
      ws, counters, M, K, N2, group, ldp, lds, ldo, out_bf16, gps);
  return (int)cudaGetLastError();
}

template <bool G1>
int launch_a8_prefill(const void* q, const void* packed, const void* scales, const float* xs, void* out, int M,
                      int K, int N2, int group, int ldp, int lds, int ldo, int out_bf16, cudaStream_t st) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(int4_mm_a8_wgmma_kernel<G1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)pf::SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid(N2 / BN2, cdiv(M, pf::BM));
  int4_mm_a8_wgmma_kernel<G1><<<grid, pf::NT, pf::SMEM, st>>>(
      static_cast<const int8_t*>(q), static_cast<const uint8_t*>(packed), static_cast<const bf16*>(scales), xs, out,
      M, K, N2, group, ldp, lds, ldo, out_bf16);
  return (int)cudaGetLastError();
}

int launch_tc_for(int M, const void* x, const void* packed, const void* scales, void* out, int K, int N2, int group,
                  int ldp, int lds, int ldo, cudaStream_t st) {
  if (M <= 16) return launch_tc<1, 1>(x, packed, scales, out, M, K, N2, group, ldp, lds, ldo, st);
  if (M <= 64) return launch_tc<2, 2>(x, packed, scales, out, M, K, N2, group, ldp, lds, ldo, st);
  return launch_tc<4, 2>(x, packed, scales, out, M, K, N2, group, ldp, lds, ldo, st);
}

int launch_quantize(const void* x, int x_bf16, const void* absmax, void* q, void* xs, int M, int K, cudaStream_t st) {
  quantize_a8_kernel<<<M, QZ_NT, 0, st>>>(x, x_bf16, static_cast<const float*>(absmax), static_cast<int8_t*>(q),
                                          static_cast<float*>(xs), K);
  return (int)cudaGetLastError();
}

}  // namespace

// q int8 [M, K], packed int8 [K, N2], scales bf16 [K/group, 2 N2] -> out [M, 2 N2] (row strides ldp, lds, ldo):
// f32 without the token scale when xs is null (out_dtype 0), else acc * xs[m] in f32 (0) or bf16 (1). At
// M <= 16 the split-K kernel needs ws (fp32 [K/group, M, 2 N2]) and counters (int32 [N2 / 64], zero, and left
// zero; no other launch may use them at the same time); split_groups > 0 sets its groups per block (else
// automatic). ws and counters are not read at M > 16.
extern "C" int int4_mm_a8(const void* q, const void* packed, const void* scales, const void* xs, void* out, void* ws,
                          void* counters, int M, int K, int N2, int group, int ldp, int lds, int ldo, int out_dtype,
                          int split_groups, void* stream) {
  if (!shapes_ok(M, K, N2, group, ldp, lds, ldo) || out_dtype < 0 || out_dtype > 1 || (out_dtype && !xs))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(xs);
  if (M > dec::M_MAX && group == pf::BK)
    return launch_a8_prefill<true>(q, packed, scales, s, out, M, K, N2, group, ldp, lds, ldo, out_dtype, st);
  if (M > dec::M_MAX)
    return launch_a8_prefill<false>(q, packed, scales, s, out, M, K, N2, group, ldp, lds, ldo, out_dtype, st);
  if (!ws || !counters) return (int)cudaErrorInvalidValue;
  float* w = static_cast<float*>(ws);
  int* c = static_cast<int*>(counters);
  const int gps = a8_split_groups(K, N2, group, split_groups);
  if (M <= 8)
    return launch_a8_decode<1>(q, packed, scales, s, out, w, c, M, K, N2, group, ldp, lds, ldo, out_dtype, gps, st);
  return launch_a8_decode<2>(q, packed, scales, s, out, w, c, M, K, N2, group, ldp, lds, ldo, out_dtype, gps, st);
}

// The number of split-K blocks per column tile int4_mm_a8 launches at M <= 16.
extern "C" int int4_mm_a8_splits(int K, int N2, int group, int split_groups) {
  return cdiv(K / group, a8_split_groups(K, N2, group, split_groups));
}

// The id of the CUDA graph capture under way on `stream`, 0 when none: the
// wrapper keeps one set of split-K tile counters per capture.
extern "C" unsigned long long stream_capture_id(void* stream) {
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  if (cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status, &id) != cudaSuccess) return 0;
  return status == cudaStreamCaptureStatusActive ? id : 0;
}

// x [M, K] (x_dtype 0: fp32, 1: bf16, contiguous) -> q int8 [M, K], xs f32 [M]. absmax: null (each row's
// own), or f32 [M] that replaces it.
extern "C" int quantize_a8(const void* x, int x_dtype, const void* absmax, void* q, void* xs, int M, int K,
                           void* stream) {
  if (M <= 0 || K <= 0 || x_dtype < 0 || x_dtype > 1) return (int)cudaErrorInvalidValue;
  return launch_quantize(x, x_dtype, absmax, q, xs, M, K, static_cast<cudaStream_t>(stream));
}

// x [M, K] (dtype 0: fp32, 1: bf16), packed, scales as above -> out [M, 2 N2] in x's dtype.
extern "C" int int4_mm(const void* x, const void* packed, const void* scales, void* out, int M, int K, int N2,
                       int group, int ldp, int lds, int ldo, int dtype, void* stream) {
  if (!shapes_ok(M, K, N2, group, ldp, lds, ldo)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && M > 64) return wg::launch(x, packed, scales, out, M, K, N2, group, ldp, lds, ldo, st);
  if (dtype == 1) return launch_tc_for(M, x, packed, scales, out, K, N2, group, ldp, lds, ldo, st);
  if (dtype == 0) return launch_f32(x, packed, scales, out, M, K, N2, group, ldp, lds, ldo, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block (bytes; 0: static only), for the build report.
extern "C" int int4_mm_smem_bytes(int M, int dtype) { return (dtype == 1 && M > 64) ? (int)wg::SMEM : 0; }
extern "C" int int4_mm_a8_smem_bytes(int M) { return M > dec::M_MAX ? (int)pf::SMEM : dec::SMEM; }
