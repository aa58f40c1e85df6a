// Routed experts for Hopper (sm_90a), plain C interface: the router, the
// routing's counts and offsets, the grouped expert products and the combine.
//
// Replaces no TPU kernel: the JAX package has no mixture of experts. The
// DeepSeek-V2 decoder's MoE layers (ops/moe.py `moe_experts`) run these five
// launches in order, with every count and offset kept in device memory, so a
// CUDA graph holds a layer with no host round trip:
//
//   moe_route: x bf16 [M, D], router bf16 [E, D] -> ids int32 [M, K] and
//     weights fp32 [M, K]: the logits in fp32 (bf16 products, fp32 sums),
//     their softmax, the top K experts by repeated argmax (descending, the
//     lower index first on a tie), renormalised (norm) or scaled.
//   moe_sort: ids [P = M K] -> counts [E] (picks per expert), each pick's
//     slot in the expert-sorted order (slots [P]) and the token of each slot
//     (rows [P]), and the tiles: (expert, first slot, rows <= BM) triples, one
//     expert's slots cut into runs of BM, with their count in n_tiles.
//   moe_grouped_gemm: over the tiles, out[slot] = A[slot] W_e^T for the
//     tile's expert e, W [E, N, K] (nn.Linear layout per expert). Gated: A is
//     x gathered through rows, W_gate and W_up both, and out = bf16(silu(g)) *
//     bf16(u) with g and u rounded to bf16 first (the published expert's
//     roundings). Plain: A is the gated output in slot order (the down
//     product), out = bf16(A W^T).
//   moe_combine: out[t] = bf16(sum_k weights[t, k] * y[slots[t, k]]) in fp32,
//     k in pick order.
//
// Atomics give the slots of one expert in no fixed order, but a row's product
// does not depend on which tile row it occupies, so the outputs are the same
// on every run.
//
// Bound: bytes. Each tile reads its expert's [N, K] weights once (both of
// them, gated), against at most BM rows: at decode (M = 1, 6 picks of 64
// experts) a DeepSeek-V2-Lite layer reads 6 x 17.3 MB, 31 us at 3.35 TB/s;
// at the 352-row prefill all 64 experts once, 1.1 GB, 330 us, for ~33 rows
// an expert (2 x 33 operations per weight element, against the ~295 per byte
// the card does). So the grouped product is a weight stream: each block
// owns one tile and BN = 64 output columns, and walks K in steps of BK = 64
// through an NS = 4-stage cp.async ring (16 KB of weights per stage, gated),
// multiplying on the tensor cores (mma.sync m16n8k16, operands by ldmatrix
// from tiles swizzled by 16-byte chunk, bf16_mma.cuh). BM = 16 or 64 rows
// per tile, chosen on the host from the mean rows an expert gets (16 at
// decode: one warp row, the 4 warps split the columns; 64 at the prefill:
// 4 warp rows, each warp all 64 columns). The grid is (N / BN, the most tiles
// the routing can give), fixed from the shapes alone; blocks past the tile
// count exit at once. The routing launches are latency-bound: one block of
// 16 warps a token for the router (its softmax and top K by warp shuffles),
// one block for the sort, and a block per token and 256 columns for the
// combine.

#include "bf16_mma.cuh"

namespace {

constexpr int NT = 128;        // threads of a product or combine block
constexpr int ROUTE_NT = 512;  // threads of a router block: 16 warps, E / 16 experts each
constexpr int SORT_NT = 256;   // threads of the sort block
constexpr int BN = 64;       // output columns per product block
constexpr int BK = 64;       // k per pipeline stage
constexpr int NS = 4;        // pipeline stages
constexpr int MAX_E = 256;   // experts the routing's shared arrays hold
constexpr int MAX_K = 16;    // experts per token

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }
__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// --- routing -----------------------------------------------------------------------

// One block per token: each warp the logits of E / 16 experts (16-byte loads,
// fp32 sums, a shuffle reduction), then warp 0 the softmax and the top K,
// K rounds of a warp argmax (the lower index first on a tie). A decode step
// routes one token, so the block's latency is the layer's.
__global__ void __launch_bounds__(ROUTE_NT)
moe_route_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w, int D, int E, int K, int norm, float scaling,
                 int* __restrict__ ids, float* __restrict__ weights) {
  __shared__ float prob[MAX_E];
  const int t = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* xr = x + (long)t * D;
  for (int e = warp; e < E; e += ROUTE_NT / 32) {
    const bf16* wr = w + (long)e * D;
    float acc = 0.f;
    for (int c = lane * 8; c < D; c += 32 * 8) {
      const uint4 xv = *reinterpret_cast<const uint4*>(xr + c);
      const uint4 wv = *reinterpret_cast<const uint4*>(wr + c);
      acc = fmaf(bf16_lo(xv.x), bf16_lo(wv.x), acc);
      acc = fmaf(bf16_hi(xv.x), bf16_hi(wv.x), acc);
      acc = fmaf(bf16_lo(xv.y), bf16_lo(wv.y), acc);
      acc = fmaf(bf16_hi(xv.y), bf16_hi(wv.y), acc);
      acc = fmaf(bf16_lo(xv.z), bf16_lo(wv.z), acc);
      acc = fmaf(bf16_hi(xv.z), bf16_hi(wv.z), acc);
      acc = fmaf(bf16_lo(xv.w), bf16_lo(wv.w), acc);
      acc = fmaf(bf16_hi(xv.w), bf16_hi(wv.w), acc);
    }
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) prob[e] = acc;
  }
  __syncthreads();
  if (warp != 0) return;
  float mx = -INFINITY;
  for (int e = lane; e < E; e += 32) mx = fmaxf(mx, prob[e]);
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float sum = 0.f;
  for (int e = lane; e < E; e += 32) {
    prob[e] = expf(prob[e] - mx);  // each lane rewrites only its own entries
    sum += prob[e];
  }
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  float total = 0.f, picked = 0.f;  // lane k keeps pick k's probability
  for (int k = 0; k < K; ++k) {
    float bv = -1.f;
    int bi = E;
    for (int e = lane; e < E; e += 32)
      if (prob[e] > bv) {
        bv = prob[e];
        bi = e;
      }
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    const float p = bv / sum;
    total += p;
    if (lane == k) picked = p;
    if (lane == 0) ids[t * K + k] = bi;
    __syncwarp();
    if (lane == bi % 32) prob[bi] = -1.f;  // taken (its owner lane rewrites it)
    __syncwarp();
  }
  if (lane < K) weights[t * K + lane] = norm ? picked / (total + 1e-20f) : picked * scaling;
}

__global__ void __launch_bounds__(SORT_NT)
moe_sort_kernel(const int* __restrict__ ids, int P, int E, int K, int BM, int* __restrict__ counts,
                int* __restrict__ rows, int* __restrict__ slots, int* __restrict__ tiles, int* __restrict__ n_tiles) {
  __shared__ int cnt[MAX_E];
  __shared__ int off[MAX_E];
  __shared__ int tile0[MAX_E];
  for (int e = threadIdx.x; e < E; e += SORT_NT) cnt[e] = 0;
  __syncthreads();
  for (int p = threadIdx.x; p < P; p += SORT_NT) atomicAdd(&cnt[ids[p]], 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    int o = 0, n = 0;
    for (int e = 0; e < E; ++e) {
      off[e] = o;
      tile0[e] = n;
      o += cnt[e];
      n += (cnt[e] + BM - 1) / BM;
    }
    *n_tiles = n;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += SORT_NT) {
    counts[e] = cnt[e];
    for (int j = 0; j * BM < cnt[e]; ++j) {
      int* tl = tiles + 3 * (tile0[e] + j);
      tl[0] = e;
      tl[1] = off[e] + j * BM;
      tl[2] = min(BM, cnt[e] - j * BM);
    }
    cnt[e] = off[e];  // from here the expert's next free slot
  }
  __syncthreads();
  for (int p = threadIdx.x; p < P; p += SORT_NT) {
    const int s = atomicAdd(&cnt[ids[p]], 1);
    rows[s] = p / K;
    slots[p] = s;
  }
}

// --- the grouped product ---------------------------------------------------------------

__device__ __forceinline__ float swiglu(float g, float u) {
  const float gb = round_bf16(g);
  return round_bf16(gb / (1.f + expf(-gb))) * round_bf16(u);
}

template <int BM, bool GATED>
constexpr size_t gemm_smem() {
  return (size_t)NS * (BM * BK * 2 + (GATED ? 2 : 1) * BN * BK * 2);
}

// Block (column block, tile). A [*, K] bf16 (rows through a_rows when given,
// else the tile's slots), W0/W1 [E, N, K] bf16, out [slots, N] bf16.
template <int BM, bool GATED>
__global__ void __launch_bounds__(NT)
moe_gemm_kernel(const bf16* __restrict__ a, const int* __restrict__ a_rows, const bf16* __restrict__ w0,
                const bf16* __restrict__ w1, const int* __restrict__ tiles, const int* __restrict__ n_tiles,
                bf16* __restrict__ out, int N, int K) {
  if ((int)blockIdx.y >= *n_tiles) return;
  constexpr int A_BYTES = BM * BK * 2, B_BYTES = BN * BK * 2;
  constexpr int STAGE = A_BYTES + (GATED ? 2 : 1) * B_BYTES;
  constexpr int A_CH = BM * 8 / NT;  // 16-byte chunks of the A tile per thread
  constexpr int B_CH = BN * 8 / NT;  // ... of one weight tile
  constexpr int WM = BM / 16, WN = 4 / WM;  // warps along rows and along columns
  constexpr int WCOLS = BN / WN, NJ = WCOLS / 8;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t s0 = smem_u32(smem);
  const int* tl = tiles + 3 * blockIdx.y;
  const int e = tl[0], r0 = tl[1], nr = tl[2];
  const int n0 = blockIdx.x * BN;
  const bf16* wb0 = w0 + ((long)e * N + n0) * K;
  const bf16* wb1 = GATED ? w1 + ((long)e * N + n0) * K : w0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp % WN;

  const bf16* a_src[A_CH];  // this thread's A rows (zero-filled past the tile's rows)
  bool a_ok[A_CH];
#pragma unroll
  for (int j = 0; j < A_CH; ++j) {
    const int r = (threadIdx.x + j * NT) / 8, c = (threadIdx.x + j * NT) % 8;
    a_ok[j] = r < nr;
    const int row = a_ok[j] ? (a_rows != nullptr ? a_rows[r0 + r] : r0 + r) : 0;
    a_src[j] = a + (long)row * K + c * 8;
  }
  auto load = [&](int stage, int kt) {
    const uint32_t base = s0 + stage * STAGE;
    const int k0 = kt * BK;
#pragma unroll
    for (int j = 0; j < A_CH; ++j) {
      const int i = threadIdx.x + j * NT;
      cp_async16(base + swz<64>(i / 8, i % 8), a_src[j] + k0, a_ok[j]);
    }
#pragma unroll
    for (int j = 0; j < B_CH; ++j) {
      const int i = threadIdx.x + j * NT, r = i / 8, c = i % 8;
      cp_async16(base + A_BYTES + swz<64>(r, c), wb0 + (long)r * K + k0 + c * 8, true);
      if (GATED) cp_async16(base + A_BYTES + B_BYTES + swz<64>(r, c), wb1 + (long)r * K + k0 + c * 8, true);
    }
  };

  float acc0[NJ][4], acc1[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc0[j][q] = acc1[j][q] = 0.f;
  const int KT = K / BK;
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // step kt has landed, and every warp is done with step kt - 1's stage
    if (kt + NS - 1 < KT) load((kt + NS - 1) % NS, kt + NS - 1);
    cp_async_commit();
    const uint32_t base = s0 + (kt % NS) * STAGE;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t af[4];
      ldsm_x4(af, base + swz<64>(wm * 16 + (lane & 15), 2 * ks + (lane >> 4)));
#pragma unroll
      for (int p = 0; p < NJ / 2; ++p) {
        const int i = lane >> 3;
        const int brow = wn * WCOLS + 16 * p + (i >> 1) * 8 + (lane & 7);
        uint32_t r[4];
        ldsm_x4(r, base + A_BYTES + swz<64>(brow, 2 * ks + (i & 1)));
        mma_bf16(acc0[2 * p], af, r[0], r[1]);
        mma_bf16(acc0[2 * p + 1], af, r[2], r[3]);
        if (GATED) {
          ldsm_x4(r, base + A_BYTES + B_BYTES + swz<64>(brow, 2 * ks + (i & 1)));
          mma_bf16(acc1[2 * p], af, r[0], r[1]);
          mma_bf16(acc1[2 * p + 1], af, r[2], r[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = n0 + wn * WCOLS + 8 * j + 2 * t;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = wm * 16 + g + 8 * hr;
      if (row >= nr) continue;
      float v0 = acc0[j][2 * hr], v1 = acc0[j][2 * hr + 1];
      if (GATED) {
        v0 = swiglu(v0, acc1[j][2 * hr]);
        v1 = swiglu(v1, acc1[j][2 * hr + 1]);
      }
      *reinterpret_cast<uint32_t*>(out + (long)(r0 + row) * N + col) = pack_bf16(v0, v1);
    }
  }
}

// Block (token, 2 NT columns): a thread a column pair.
__global__ void __launch_bounds__(NT)
moe_combine_kernel(const bf16* __restrict__ y, const int* __restrict__ slots, const float* __restrict__ weights,
                   bf16* __restrict__ out, int D, int K) {
  const int t = blockIdx.x;
  const int n = 2 * (blockIdx.y * NT + threadIdx.x);
  if (n < D) {
    float s0 = 0.f, s1 = 0.f;
    for (int k = 0; k < K; ++k) {
      const float wk = weights[t * K + k];
      const uint32_t pair = *reinterpret_cast<const uint32_t*>(y + (long)slots[t * K + k] * D + n);
      s0 += wk * bf16_lo(pair);
      s1 += wk * bf16_hi(pair);
    }
    *reinterpret_cast<uint32_t*>(out + (long)t * D + n) = pack_bf16(s0, s1);
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes, bool& configured) {
  if (configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) configured = true;
  return err;
}

template <int BM, bool GATED>
cudaError_t launch_gemm(const void* a, const void* a_rows, const void* w0, const void* w1, const void* tiles,
                        const void* n_tiles, void* out, int N, int K, int max_tiles, cudaStream_t st) {
  constexpr size_t smem = gemm_smem<BM, GATED>();
  static bool configured = false;
  cudaError_t err = set_smem(moe_gemm_kernel<BM, GATED>, smem, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / BN, max_tiles);
  moe_gemm_kernel<BM, GATED><<<grid, NT, smem, st>>>(
      static_cast<const bf16*>(a), static_cast<const int*>(a_rows), static_cast<const bf16*>(w0),
      static_cast<const bf16*>(w1), static_cast<const int*>(tiles), static_cast<const int*>(n_tiles),
      static_cast<bf16*>(out), N, K);
  return cudaGetLastError();
}

cudaError_t launch_route(const void* x, const void* w, void* ids, void* weights, int M, int D, int E, int K,
                         int norm, float scaling, cudaStream_t st) {
  moe_route_kernel<<<M, ROUTE_NT, 0, st>>>(static_cast<const bf16*>(x), static_cast<const bf16*>(w), D, E, K, norm,
                                           scaling, static_cast<int*>(ids), static_cast<float*>(weights));
  return cudaGetLastError();
}

cudaError_t launch_sort(const void* ids, void* counts, void* rows, void* slots, void* tiles, void* n_tiles, int P,
                        int E, int K, int BM, cudaStream_t st) {
  moe_sort_kernel<<<1, SORT_NT, 0, st>>>(static_cast<const int*>(ids), P, E, K, BM, static_cast<int*>(counts),
                                         static_cast<int*>(rows), static_cast<int*>(slots), static_cast<int*>(tiles),
                                         static_cast<int*>(n_tiles));
  return cudaGetLastError();
}

cudaError_t launch_combine(const void* y, const void* slots, const void* weights, void* out, int M, int D, int K,
                           cudaStream_t st) {
  const dim3 grid(M, (D + 2 * NT - 1) / (2 * NT));
  moe_combine_kernel<<<grid, NT, 0, st>>>(static_cast<const bf16*>(y), static_cast<const int*>(slots),
                                          static_cast<const float*>(weights), static_cast<bf16*>(out), D, K);
  return cudaGetLastError();
}

}  // namespace

// Each returns the cudaError_t of its launch (0 on success), or
// cudaErrorInvalidValue for shapes outside the kernels': D a multiple of 8
// (route), E <= 256, K <= 16, BM 16 or 64, N and K multiples of 64.
extern "C" int moe_route(const void* x, const void* router, void* ids, void* weights, int M, int D, int E, int K,
                         int norm, float scaling, void* stream) {
  if (M < 1 || D % 8 || E < 1 || E > MAX_E || K < 1 || K > MAX_K || K > E) return (int)cudaErrorInvalidValue;
  return launch_route(x, router, ids, weights, M, D, E, K, norm, scaling, static_cast<cudaStream_t>(stream));
}

extern "C" int moe_sort(const void* ids, void* counts, void* rows, void* slots, void* tiles, void* n_tiles, int P,
                        int E, int K, int BM, void* stream) {
  if (P < 1 || E < 1 || E > MAX_E || K < 1 || BM < 1) return (int)cudaErrorInvalidValue;
  return launch_sort(ids, counts, rows, slots, tiles, n_tiles, P, E, K, BM, static_cast<cudaStream_t>(stream));
}

// a_rows null: A's row of each slot is the slot itself. gated: w1 is the up
// weight and out the SwiGLU; else w1 is unused.
extern "C" int moe_grouped_gemm(const void* a, const void* a_rows, const void* w0, const void* w1, const void* tiles,
                                const void* n_tiles, void* out, int N, int K, int BM, int max_tiles, int gated,
                                void* stream) {
  if (N % BN || K % BK || N < BN || K < BK || max_tiles < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GEMM_ARGS a, a_rows, w0, w1, tiles, n_tiles, out, N, K, max_tiles, st
  switch (BM * 2 + (gated ? 1 : 0)) {
    case 33: return launch_gemm<16, true>(GEMM_ARGS);
    case 32: return launch_gemm<16, false>(GEMM_ARGS);
    case 129: return launch_gemm<64, true>(GEMM_ARGS);
    case 128: return launch_gemm<64, false>(GEMM_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef GEMM_ARGS
}

extern "C" int moe_combine(const void* y, const void* slots, const void* weights, void* out, int M, int D, int K,
                           void* stream) {
  if (M < 1 || D % 2 || K < 1) return (int)cudaErrorInvalidValue;
  return launch_combine(y, slots, weights, out, M, D, K, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of one product block (bytes), for the build report.
extern "C" int moe_grouped_gemm_smem_bytes(int BM, int gated) {
  switch (BM * 2 + (gated ? 1 : 0)) {
    case 33: return (int)gemm_smem<16, true>();
    case 32: return (int)gemm_smem<16, false>();
    case 129: return (int)gemm_smem<64, true>();
    case 128: return (int)gemm_smem<64, false>();
    default: return -1;
  }
}
