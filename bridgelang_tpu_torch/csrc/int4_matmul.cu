// Packed-int4 weight matmuls for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU kernels of bridgelang_tpu/ops/int4_matmul.py
// (both launched from `_int4_2d`):
//   int4_mm_a8  <- `_kernel_a8` (w4a8): int8 activations q [M, K] x packed
//                  int4 weights -> f32 [M, N], the per-token scale left to
//                  the caller. Products on the int8 tensor cores
//                  (mma.sync m16n8k32 s8 -> s32), exact int32 sums per
//                  quantization group.
//   int4_mm     <- `_kernel` (float activations): x [M, K] in bf16 (bf16
//                  tensor cores, mma.sync m16n8k16, fp32 sums) or in fp32 (an
//                  FMA variant: no TF32 and no bf16 rounding of x, as the
//                  JAX kernel's dot promotes f32 x bf16 to f32) -> x's dtype.
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
// which is what the plain versions in ops/int4_matmul.py do. So the a8 kernel
// equals its plain version bit for bit; the float kernels differ from theirs
// only in the fp32 order of each group's dot.
//
// Design. A block computes BM rows x 64 packed columns (128 output columns:
// 64 low, 64 high). The K loop stages 64 input rows at a time: the activation
// tile as is, the weight tile unpacked into two K-contiguous code planes (low
// and high nibbles) in shared memory, the 4 x 4 byte transposes done with
// __byte_perm, so that each mma B fragment is one 32-bit shared load. Warps
// are 2 along N (32 packed columns each, 4 n8 tiles per half) and 1, 2 or 4
// along M (16 or 32 rows each); a group's partial sums stay in the mma
// accumulators and fold into fp32 accumulators at the group's end.
//
// Bound. Decode (M = 1) streams the packed bytes once: 7B's w_gate is 22.5 MB
// + 0.7 MB of scales, ~6.9 us at 3.35 TB/s; the kernel is bound by bytes
// there and a 16-row mma tile wastes 15/16 of its products, which costs
// nothing against that bound. QLoRA (M = 5632, bf16) is bound by operations:
// 2 x 5632 x 4096 x 11008 = 5.1e11 for w_gate, ~0.51 ms at 989 TFLOP/s, which
// is why even this first version uses the tensor cores. Left for later:
// cp.async/TMA staging overlapped with the products (here one buffer,
// __syncthreads around each stage), wgmma, split-K for the decode shapes
// (N/2 / 64 blocks: 32 for 4096-wide outputs, under one wave of 132 SMs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BK = 64;   // input rows staged per step; divides every group
constexpr int BN2 = 64;  // packed columns per block

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

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

// Stage packed rows k0..k0+63, columns n0..n0+63 into K-contiguous code
// planes: plane[col * SW + k] (elements of type E: int8 or bf16).
template <typename E, int NT, int SW>
__device__ __forceinline__ void stage_weights(E* wlo, E* whi, const uint8_t* __restrict__ packed, int ldp,
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
        if constexpr (sizeof(E) == 1) {
          *reinterpret_cast<uint32_t*>(wlo + col * SW + 4 * kq) = codes_s8(lo_biased(cols[j]));
          *reinterpret_cast<uint32_t*>(whi + col * SW + 4 * kq) = codes_s8(hi_biased(cols[j]));
        } else {
          *reinterpret_cast<uint2*>(wlo + col * SW + 4 * kq) = codes_bf16(lo_biased(cols[j]));
          *reinterpret_cast<uint2*>(whi + col * SW + 4 * kq) = codes_bf16(hi_biased(cols[j]));
        }
      }
    }
  }
}

// Stage activation rows m0..m0+BM-1, columns k0..k0+63 (rows past M zero).
template <typename E, int NT, int BM, int SX>
__device__ __forceinline__ void stage_x(E* xs, const E* __restrict__ x, int M, int K, int m0, int k0) {
  constexpr int V = 16 / sizeof(E);  // elements per 16-byte load
  for (int i = threadIdx.x; i < BM * (BK / V); i += NT) {
    const int r = i / (BK / V), c = (i % (BK / V)) * V;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (m0 + r < M) v = *reinterpret_cast<const uint4*>(x + (long)(m0 + r) * K + k0 + c);
    *reinterpret_cast<uint4*>(xs + r * SX + c) = v;
  }
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

__device__ __forceinline__ uint32_t ld32(const void* p) { return *reinterpret_cast<const uint32_t*>(p); }

// acc += float(y) * s, product and sum rounded separately (the plain order).
__device__ __forceinline__ float fold(float acc, float y, float s) { return __fadd_rn(acc, __fmul_rn(y, s)); }

// One kernel for both tensor-core variants. A8: E = int8, int32 partial sums,
// f32 output; else E = bf16, fp32 partial sums, bf16 output.
template <bool A8, int WARPS_M, int MT>
__global__ void __launch_bounds__(WARPS_M * 64)
int4_mm_tc_kernel(const void* __restrict__ xv, const uint8_t* __restrict__ packed,
                  const __nv_bfloat16* __restrict__ scales, void* __restrict__ outv, int M, int K, int N2,
                  int group, int ldp, int lds, int ldo) {
  using E = std::conditional_t<A8, int8_t, __nv_bfloat16>;
  using Acc = std::conditional_t<A8, int, float>;
  constexpr int NT = WARPS_M * 64;
  constexpr int BM = WARPS_M * MT * 16;
  constexpr int PADE = 16 / sizeof(E);       // 16 bytes of padding per staged row
  constexpr int SX = BK + PADE, SW = BK + PADE;
  constexpr int KSTEP = A8 ? 32 : 16;        // mma depth in elements
  constexpr int KW = 4 / sizeof(E);          // elements per 32-bit fragment register
  __shared__ __align__(16) E xs[BM * SX];
  __shared__ __align__(16) E wlo[BN2 * SW];
  __shared__ __align__(16) E whi[BN2 * SW];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN2;
  const E* x = static_cast<const E*>(xv);

  Acc c_lo[MT][4][4], c_hi[MT][4][4];
  float acc_lo[MT][4][4], acc_hi[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c_lo[mt][j][e] = c_hi[mt][j][e] = 0, acc_lo[mt][j][e] = acc_hi[mt][j][e] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // the previous step's fragments are read
    stage_x<E, NT, BM, SX>(xs, x, M, K, m0, k0);
    stage_weights<E, NT, SW>(wlo, whi, packed, ldp, k0, n0);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += KSTEP) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const E* row = xs + (wm * MT * 16 + mt * 16 + g) * SX + ks + KW * t;
        a[mt][0] = ld32(row);
        a[mt][1] = ld32(row + 8 * SX);
        a[mt][2] = ld32(row + KSTEP / 2);
        a[mt][3] = ld32(row + 8 * SX + KSTEP / 2);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn * 32 + j * 8 + g;
        const uint32_t bl0 = ld32(wlo + n * SW + ks + KW * t), bl1 = ld32(wlo + n * SW + ks + KSTEP / 2 + KW * t);
        const uint32_t bh0 = ld32(whi + n * SW + ks + KW * t), bh1 = ld32(whi + n * SW + ks + KSTEP / 2 + KW * t);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (A8) {
            mma_s8(c_lo[mt][j], a[mt], bl0, bl1);
            mma_s8(c_hi[mt][j], a[mt], bh0, bh1);
          } else {
            mma_bf16(c_lo[mt][j], a[mt], bl0, bl1);
            mma_bf16(c_hi[mt][j], a[mt], bh0, bh1);
          }
        }
      }
    }
    if ((k0 + BK) % group == 0) {  // the group ends: fold its sums, in group order
      const __nv_bfloat16* srow = scales + (long)((k0 + BK) / group - 1) * lds;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn * 32 + j * 8 + 2 * t;
        const float2 sl = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(srow + col));
        const float2 sh = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(srow + N2 + col));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc_lo[mt][j][e] = fold(acc_lo[mt][j][e], (float)c_lo[mt][j][e], (e & 1) ? sl.y : sl.x);
            acc_hi[mt][j][e] = fold(acc_hi[mt][j][e], (float)c_hi[mt][j][e], (e & 1) ? sh.y : sh.x);
            c_lo[mt][j][e] = c_hi[mt][j][e] = 0;
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
        if constexpr (A8) {
          float* out = static_cast<float*>(outv);
          *reinterpret_cast<float2*>(out + base) = make_float2(acc_lo[mt][j][2 * h], acc_lo[mt][j][2 * h + 1]);
          *reinterpret_cast<float2*>(out + base + N2) = make_float2(acc_hi[mt][j][2 * h], acc_hi[mt][j][2 * h + 1]);
        } else {
          __nv_bfloat16* out = static_cast<__nv_bfloat16*>(outv);
          *reinterpret_cast<__nv_bfloat162*>(out + base) =
              __floats2bfloat162_rn(acc_lo[mt][j][2 * h], acc_lo[mt][j][2 * h + 1]);
          *reinterpret_cast<__nv_bfloat162*>(out + base + N2) =
              __floats2bfloat162_rn(acc_hi[mt][j][2 * h], acc_hi[mt][j][2 * h + 1]);
        }
      }
    }
  }
}

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

template <bool A8, int WARPS_M, int MT>
int launch_tc(const void* x, const void* packed, const void* scales, void* out, int M, int K, int N2, int group,
              int ldp, int lds, int ldo, cudaStream_t st) {
  constexpr int BM = WARPS_M * MT * 16;
  const dim3 grid(N2 / BN2, cdiv(M, BM));
  int4_mm_tc_kernel<A8, WARPS_M, MT><<<grid, WARPS_M * 64, 0, st>>>(
      x, static_cast<const uint8_t*>(packed), static_cast<const __nv_bfloat16*>(scales), out, M, K, N2, group, ldp, lds, ldo);
  return (int)cudaGetLastError();
}

template <bool A8>
int launch_tc_for(int M, const void* x, const void* packed, const void* scales, void* out, int K, int N2, int group,
                  int ldp, int lds, int ldo, cudaStream_t st) {
  if (M <= 16) return launch_tc<A8, 1, 1>(x, packed, scales, out, M, K, N2, group, ldp, lds, ldo, st);
  if (M <= 64) return launch_tc<A8, 2, 2>(x, packed, scales, out, M, K, N2, group, ldp, lds, ldo, st);
  return launch_tc<A8, 4, 2>(x, packed, scales, out, M, K, N2, group, ldp, lds, ldo, st);
}

// Row strides: packed rows 16-byte aligned (ldp % 16), scale and output rows
// even (their paired loads and stores), none shorter than its row.
bool shapes_ok(int M, int K, int N2, int group, int ldp, int lds, int ldo) {
  return M > 0 && group > 0 && group % 128 == 0 && K % group == 0 && N2 > 0 && N2 % BN2 == 0 && ldp >= N2 &&
         ldp % 16 == 0 && lds >= 2 * N2 && lds % 2 == 0 && ldo >= 2 * N2 && ldo % 2 == 0;
}

}  // namespace

// q int8 [M, K], packed int8 [K, N2], scales bf16 [K/group, 2 N2] -> out f32 [M, 2 N2]
// (row strides ldp, lds, ldo).
extern "C" int int4_mm_a8(const void* q, const void* packed, const void* scales, void* out, int M, int K, int N2,
                          int group, int ldp, int lds, int ldo, void* stream) {
  if (!shapes_ok(M, K, N2, group, ldp, lds, ldo)) return (int)cudaErrorInvalidValue;
  return launch_tc_for<true>(M, q, packed, scales, out, K, N2, group, ldp, lds, ldo,
                             static_cast<cudaStream_t>(stream));
}

// x [M, K] (dtype 0: fp32, 1: bf16), packed, scales as above -> out [M, 2 N2] in x's dtype.
extern "C" int int4_mm(const void* x, const void* packed, const void* scales, void* out, int M, int K, int N2,
                       int group, int ldp, int lds, int ldo, int dtype, void* stream) {
  if (!shapes_ok(M, K, N2, group, ldp, lds, ldo)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_tc_for<false>(M, x, packed, scales, out, K, N2, group, ldp, lds, ldo, st);
  if (dtype == 0) {
    const dim3 grid(N2 / BN2, cdiv(M, F_BM));
    int4_mm_f32_kernel<<<grid, F_NT, 0, st>>>(static_cast<const float*>(x), static_cast<const uint8_t*>(packed),
                                              static_cast<const __nv_bfloat16*>(scales), static_cast<float*>(out),
                                              M, K, N2, group, ldp, lds, ldo);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
