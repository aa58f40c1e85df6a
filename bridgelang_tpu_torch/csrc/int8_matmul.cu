// int8 weight-only GEMV for Hopper (sm_90a), plain C interface.
//
// Replaces no TPU kernel: the JAX package's int8 route casts the weight to the
// activation dtype inside one XLA fusion (`_block.proj`, `lm_logits`). On the
// card that cast was ATen's elementwise copy of every int8 weight to bf16,
// then cuBLAS over the copy: per decode token ~35 GB moved for 7.1 GB of codes
// (Mistral-7B). This kernel multiplies the bf16 activations by the int8 codes
// directly, so each code byte is read once and no bf16 copy is written:
//
//   int8_gemv: x bf16 [M, K] (contiguous), w int8 [N, K] (contiguous, the
//   port's [out, in] layout), scale bf16 [N] or null -> out bf16 [M, N],
//   out[m, n] = bf16(bf16(sum_k x[m, k] w[n, k]) * scale[n])  (fp32 sums),
//   or bf16(sum) without a scale (a tensor-parallel row block's partial, scaled
//   after the reduce). 1 <= M <= 16, K a multiple of 16, any N.
//
// That is the cast route's arithmetic, F.linear(x, w.to(bf16)) * s.to(bf16):
// one rounding of the fp32 sum, one of the scaled value. The codes convert to
// bf16 exactly (|code| <= 128), so kernel and plain version differ only in the
// order of the fp32 sums.
//
// Bound: bytes. At M <= 16 the product does at most 2 M = 32 operations per
// weight byte, against the ~295 (bf16) the card can do per byte it reads; a
// Mistral-7B decode step reads 7.11 GB of codes, 2.12 ms at 3.35 TB/s. So the
// design streams every code byte exactly once and keeps enough of them in
// flight:
//
// * A warp owns 8 output rows and streams them through a ring in shared
//   memory: lane (g, t) copies 16 bytes of row n0 + g at k and at k + 64 per
//   128-k step by cp.async (the 4 lanes of a row: 128 contiguous bytes), two
//   steps ahead of the one it multiplies (NS = 3 slots). A lane reads back
//   only the slots it filled, so the loop has no barrier: no warp waits for
//   another's bytes. On the card 3 slots were as fast as or faster than 4
//   and 5 at every Mistral shape at M = 1, and deeper rings (6, 8, 12)
//   slower (PERF.md): more requests in flight only queue longer.
// * The product runs transposed on the tensor cores, out^T = x w^T as
//   mma.sync m16n8k16 bf16 -> fp32: A is x (16 rows; rows past M are zero),
//   B is the warp's 8 weight rows. A B fragment wants 4 k of one row per lane,
//   which 16 loaded bytes give for 4 mmas once K is permuted: in mma j, lane
//   t's logical k 2t, 2t + 1 (and 2t + 8, 2t + 9) are the physical k 16t + 4j,
//   + 1 (and + 2, + 3) of its chunk. x is read in the same permutation. The
//   codes become bf16 in registers: byte ^ 0x80 under the fp32 exponent of
//   2^23 is 2^23 + 128 + code exactly, one subtract leaves the code, whose
//   fp32 bits' upper half is its bf16 (no rounding: |code| <= 128).
// * x (at most 16 rows) is read by each lane where it multiplies, 32 bytes of
//   a row per chunk, one step ahead, through L1, which the block's R row
//   groups share (they walk the same k); rows 8 .. 15 only in the M > 8
//   instance. Staging x in shared memory per K tile (a first version) needed
//   a barrier per tile, which held every warp to the slowest warp's codes:
//   44-61 % of the byte bound at M = 1, against 54-76 % now (PERF.md).
// * Filling 132 SMs in one wave: a block of 8 warps owns units of R row
//   groups (8 R rows) and splits K S = 8 / R ways inside the block; the S
//   partial sums of a row group are added in warp order through shared
//   memory (deterministic: no atomics, no second pass). At M <= 4, R is the
//   smallest of 1, 2, 4, 8 whose units all fit the card's resident blocks
//   at once (so no second, thin wave of blocks streams alone at the end); at
//   M > 4, the largest that still gives every SM a block, since x is read
//   from L2 once per block. Where even 8 groups leave more units than
//   resident blocks (Phi-2's head: 800), every block walks as many units.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int NT = 256;               // 8 warps per block
constexpr int WARPS = NT / 32;
constexpr int M_MAX = 16;             // rows of x: the mma's A rows
constexpr int STEP = 128;             // k per warp step: two 16-byte chunks per lane, 4 lanes per row
constexpr int NS = 3;                 // ring stages (steps) per lane: NS - 1 steps of codes in flight
constexpr int RING = NS * NT * 32;    // the ring: [stage][chunk][thread] x 16 bytes, 24 KB
constexpr int SMS = 132;              // the H100's SMs

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// PTX wrappers (tests/cuda_emu/cuda_emu.h emulates each of this block).
// 16 bytes global -> shared; zero-filled (nothing read) unless `valid`.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four int8 codes (k order from the low byte) -> two bf16x2: b0 = (c0, c1), b1 = (c2, c3), exactly.
__device__ __forceinline__ void codes_bf16x2(uint32_t w, uint32_t& b0, uint32_t& b1) {
  const uint32_t u = w ^ 0x80808080u;  // each byte as 128 + code
  constexpr uint32_t EXP = 0x4B000000u;  // fp32 2^23: the low byte is the integer part
  const float f0 = __uint_as_float(__byte_perm(u, EXP, 0x7650)) - 8388736.0f;  // 2^23 + 128
  const float f1 = __uint_as_float(__byte_perm(u, EXP, 0x7651)) - 8388736.0f;
  const float f2 = __uint_as_float(__byte_perm(u, EXP, 0x7652)) - 8388736.0f;
  const float f3 = __uint_as_float(__byte_perm(u, EXP, 0x7653)) - 8388736.0f;
  b0 = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  b1 = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// Ring slot of chunk h of `stage` for this thread: consecutive threads, consecutive 16 bytes.
__device__ __forceinline__ uint32_t slot(int stage, int h) { return (uint32_t)(((stage * 2 + h) * NT + threadIdx.x) * 16); }

// The thread's two chunks of one step: row `wrow` at k and k + 64 (zero past K or past N: nothing read).
__device__ __forceinline__ void fetch_codes(uint32_t ring, int stage, const int8_t* __restrict__ wrow, bool row_ok,
                                            int K, int k) {
  cp_async16(ring + slot(stage, 0), wrow + (row_ok && k < K ? k : 0), row_ok && k < K);
  cp_async16(ring + slot(stage, 1), wrow + (row_ok && k + 64 < K ? k + 64 : 0), row_ok && k + 64 < K);
}

// x row m at one step's 16 k of each chunk (k and k + 64): v[h] holds pairs (0, 1), (2, 3), .. (14, 15) of
// chunk h (zero for a row past M or k past K).
__device__ __forceinline__ void x_step(uint32_t (&v)[2][8], const bf16* __restrict__ x, bool ok, int K, int m, int k) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint4 a = make_uint4(0, 0, 0, 0), b = a;
    if (ok && k + 64 * h < K) {
      a = *reinterpret_cast<const uint4*>(x + (long)m * K + k + 64 * h);
      b = *reinterpret_cast<const uint4*>(x + (long)m * K + k + 64 * h + 8);
    }
    v[h][0] = a.x, v[h][1] = a.y, v[h][2] = a.z, v[h][3] = a.w, v[h][4] = b.x, v[h][5] = b.y, v[h][6] = b.z,
    v[h][7] = b.w;
  }
}

// A block owns row tiles of 8 R rows (unit u: rows 8 R u .. 8 R (u + 1) - 1), walking units blockIdx.x,
// + gridDim.x, ...: warp w is row group r = w / S (rows n0 .. n0 + 7) and K split s = w % S, taking the 128-k
// steps s, s + S, s + 2 S, ... of its rows. Lane (g, t) streams row n0 + g through its own slots of the ring
// (it reads back only what it copied, so the loop has no barrier) and reads x rows g and g + 8 through L1; its
// accumulators c[e] hold out[m = g + 8 (e >> 1)][n0 + 2t + (e & 1)].
template <int R, bool HI>
__global__ void __launch_bounds__(NT)
int8_gemv_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w, const bf16* __restrict__ scale,
                 bf16* __restrict__ out, int M, int N, int K) {
  constexpr int S = WARPS / R;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float red[WARPS][32][4];
  const uint32_t ring = smem_u32(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r = warp / S, s = warp % S;
  const int steps = cdiv(K, STEP), mine = s < steps ? cdiv(steps - s, S) : 0;
  const int units = cdiv(cdiv(N, 8), R);
  const bool lo_ok = g < M, hi_ok = HI && g + 8 < M;  // HI: M > 8, x rows 8 .. 15 exist

  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int n0 = (unit * R + r) * 8;
    const bool row_ok = n0 + g < N;
    const int8_t* wrow = w + (long)(row_ok ? n0 + g : 0) * K;
#pragma unroll
    for (int i = 0; i < NS - 1; ++i) {
      if (i < mine) fetch_codes(ring, i, wrow, row_ok, K, (s + i * S) * STEP + 16 * t);
      cp_async_commit();
    }
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    uint32_t xl[2][8], xh[2][8];  // x rows g and g + 8 for the next step, loaded a step ahead
    x_step(xl, x, lo_ok, K, g, s * STEP + 16 * t);
    if (HI) x_step(xh, x, hi_ok, K, g + 8, s * STEP + 16 * t);
    for (int i = 0; i < mine; ++i) {
      cp_async_wait<NS - 2>();  // this thread's copies of step i have landed
      const int st = i % NS;
      const uint4 c[2] = {*reinterpret_cast<const uint4*>(smem + slot(st, 0)),
                          *reinterpret_cast<const uint4*>(smem + slot(st, 1))};
      if (i + NS - 1 < mine) fetch_codes(ring, (i + NS - 1) % NS, wrow, row_ok, K, (s + (i + NS - 1) * S) * STEP + 16 * t);
      cp_async_commit();
      uint32_t al[2][8], ah[2][8];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 8; ++q) al[h][q] = xl[h][q], ah[h][q] = HI ? xh[h][q] : 0u;
      if (i + 1 < mine) {
        x_step(xl, x, lo_ok, K, g, (s + (i + 1) * S) * STEP + 16 * t);
        if (HI) x_step(xh, x, hi_ok, K, g + 8, (s + (i + 1) * S) * STEP + 16 * t);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t wd[4] = {c[h].x, c[h].y, c[h].z, c[h].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // mma j: physical k 4j .. 4j + 3 of the lane's 16
          uint32_t b0, b1;
          codes_bf16x2(wd[j], b0, b1);
          const uint32_t a[4] = {al[h][2 * j], ah[h][2 * j], al[h][2 * j + 1], ah[h][2 * j + 1]};
          mma_bf16(acc, a, b0, b1);
        }
      }
    }
    cp_async_wait<0>();

    // The row group's S partial sums, added in warp order; then one rounding, the column scale, a second one.
#pragma unroll
    for (int e = 0; e < 4; ++e) red[warp][lane][e] = acc[e];
    __syncthreads();
    if (s == 0) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sum = red[warp][lane][e];
        for (int q = 1; q < S; ++q) sum = __fadd_rn(sum, red[warp + q][lane][e]);
        const int m = g + 8 * (e >> 1), n = n0 + 2 * t + (e & 1);
        if (m >= M || n >= N) continue;
        bf16 y = __float2bfloat16_rn(sum);
        if (scale) y = __float2bfloat16_rn(__fmul_rn(__bfloat162float(y), __bfloat162float(scale[n])));
        out[(long)m * N + n] = y;
      }
    }
    __syncthreads();  // red is read before the next unit writes it
  }
}

// Resident blocks per SM of each kernel (R, HI), found once.
int per_sm[WARPS + 1][2];

template <int R, bool HI>
int configure() {
  if (per_sm[R][HI]) return 0;
  cudaError_t err =
      cudaFuncSetAttribute(int8_gemv_kernel<R, HI>, cudaFuncAttributeMaxDynamicSharedMemorySize, RING);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[R][HI], int8_gemv_kernel<R, HI>, NT, RING);
  if (err != cudaSuccess) return (int)err;
  per_sm[R][HI] = per_sm[R][HI] > 0 ? per_sm[R][HI] : 1;
  return 0;
}

template <bool HI>
int configure_all() {
  int err = configure<1, HI>();
  if (!err) err = configure<2, HI>();
  if (!err) err = configure<4, HI>();
  if (!err) err = configure<8, HI>();
  return err;
}

int configure_all() {
  const int err = configure_all<false>();
  return err ? err : configure_all<true>();
}

// Row groups per block. At M <= 4 the fewest that keep every block resident at once (one wave: no tail of
// stragglers while the card idles); above, the most that still give every SM a block (x, read from L2 once
// per block and M times larger, then weighs on the bytes). Past 8 groups a block walks several units.
int row_groups(int M, int N) {
  const int groups = cdiv(N, 8), hi = M > 8;
  if (M <= 4) {
    for (int R = 1; R < WARPS; R *= 2)
      if (cdiv(groups, R) <= per_sm[R][hi] * SMS) return R;
    return WARPS;
  }
  int R = WARPS;
  while (R > 1 && cdiv(groups, R) < SMS) R /= 2;
  return R;
}

int blocks(int R, int M, int N) {
  const int units = cdiv(cdiv(N, 8), R), slots = per_sm[R][M > 8] * SMS;
  return cdiv(units, cdiv(units, slots));  // as many units for every block
}

template <int R, bool HI>
int launch(const void* x, const void* w, const void* scale, void* out, int M, int N, int K, cudaStream_t st) {
  const dim3 grid(blocks(R, M, N));
  int8_gemv_kernel<R, HI><<<grid, NT, RING, st>>>(static_cast<const bf16*>(x), static_cast<const int8_t*>(w),
                                                  static_cast<const bf16*>(scale), static_cast<bf16*>(out), M, N, K);
  return (int)cudaGetLastError();
}

template <bool HI>
int launch_for(int R, const void* x, const void* w, const void* scale, void* out, int M, int N, int K,
               cudaStream_t st) {
  switch (R) {
    case 8: return launch<8, HI>(x, w, scale, out, M, N, K, st);
    case 4: return launch<4, HI>(x, w, scale, out, M, N, K, st);
    case 2: return launch<2, HI>(x, w, scale, out, M, N, K, st);
    default: return launch<1, HI>(x, w, scale, out, M, N, K, st);
  }
}

}  // namespace

// x bf16 [M, K], w int8 [N, K], scale bf16 [N] or null -> out bf16 [M, N], all contiguous; x and w 16-byte
// aligned. 1 <= M <= 16, K a positive multiple of 16, N >= 1; anything else returns cudaErrorInvalidValue.
extern "C" int int8_gemv(const void* x, const void* w, const void* scale, void* out, int M, int N, int K,
                         void* stream) {
  if (M < 1 || M > M_MAX || N < 1 || K < 16 || K % 16 != 0) return (int)cudaErrorInvalidValue;
  if (int err = configure_all()) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int R = row_groups(M, N);
  return M > 8 ? launch_for<true>(R, x, w, scale, out, M, N, K, st)
               : launch_for<false>(R, x, w, scale, out, M, N, K, st);
}

// The row groups per block int8_gemv launches at (M, N), and its grid, for the report and the tests.
extern "C" int int8_gemv_row_groups(int M, int N) { return configure_all() ? -1 : row_groups(M, N); }
extern "C" int int8_gemv_blocks(int M, int N) { return configure_all() ? -1 : blocks(row_groups(M, N), M, N); }
