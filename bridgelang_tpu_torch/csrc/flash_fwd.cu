// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces bridgelang_tpu/ops/flash_attention.py::_fwd_kernel (the Pallas TPU
// kernel behind `flash_attention`, launched from `_fwd_pallas`). It computes
// the same function: online-softmax attention with fp32 running max, sum and
// accumulator; causal masking; a per-example count of valid keys (`lengths`,
// right padding); GQA (query head h reads KV head h / (H / Hkv)); an optional
// sliding window (row r attends keys in (r - window, r]); keys at least as
// long as queries (queries sit at key slots 0..T-1). Outputs are `o` in the
// input type and the row log-sum-exp `lse` as f32 [B, H, T]. The TPU
// kernel's replicated STAT_W lane width is dropped. bf16 inputs may also
// write `o` in fp32 (`out_dtype`): a ring block's output, which the ring
// merges in fp32 and rounds once, as the JAX ring's fp32 blocks do. That
// variant also carries P into PV as a bf16 pair hi + lo, since the ring's
// backward forms delta = rowsum(dO * O) from this o: with P rounded once,
// o's error (~2e-3 at T = 144) moves dq and dk 3-5 times past GRAD_TOL from
// JAX's fp32 arithmetic (tests/test_torch_kernels_emulated.py).
//
// Layouts are the public API's: q/o [B, T, H, D], k/v [B, S, Hkv, D], all
// contiguous, so no transpose runs before or after the kernel. Both variants
// run one thread block per (64-query tile, head, example): blocks run in
// parallel, so the TPU kernel's sequential grid walk becomes a loop inside
// the block over 64-key tiles from `lower` to `upper`, with the TPU kernel's
// causal, length and window bounds (flash_attention.py:69-77). Key rows past
// the valid length are zero-filled, so a dead cache slot holding non-finite
// values cannot leak into a row through a zero probability.
//
// bf16: FlashAttention-2 on the tensor cores. 4 warps, each owning 16 query
// rows. QK^T and PV run on mma.sync m16n8k16 (bf16 in, fp32 sums), their
// operands loaded with ldmatrix (.trans for V) from shared tiles swizzled by
// 16-byte chunk (chunk ^ row % 8), so neither the cp.async stores nor the
// ldmatrix reads conflict on banks. Q's fragments are loaded once and stay in
// registers; the probabilities stay in registers too: the fp32 score
// accumulators are exponentiated in place, rounded to bf16 and reused as the
// A operand of PV. K and V tiles go through a cp.async double buffer (the
// src-size-0 form zero-fills rows past `len`), so the next tile's loads
// overlap this tile's products. Scores are scaled in fp32 with log2(e)
// folded in and exponentiated with exp2f; the causal, length and window
// masks run only on the tiles that cross an edge. Output rows are staged
// through the (then idle) Q tile and written as 16-byte stores.
//
// fp32: the products on the FMA units (two threads per query row, tiles
// staged as fp32), kept for the card-vs-CPU fp32 parity run, which needs
// fp32 products: TF32 or bf16 rounding would move its token ids.
//
// The cp.async, ldmatrix, mma.sync and swizzle helpers are bf16_mma.cuh's,
// shared with flash_bwd.cu.
//
// Bound at the main path's shapes. Train (B=16, T=S=352, H=32, D=128): q, k,
// v and o are 4 x 16 x 352 x 4096 x 2 B = 184 MB, 55 us at 3.35 TB/s; the
// causal products are ~16 GFLOP, 16 us at the 989 TFLOP/s bf16 peak. Serve
// (B=1): 11.5 MB, 3.5 us. So the work is bound by bytes, and mma.sync's
// share of the bf16 peak keeps the operations term under the byte term at
// these lengths.
//
// Latent attention (DeepSeek-V2's prefill, expanded): q and k carry 192 dims
// (128 + a 64-dim rope part), v 128, and the softmax scale is YaRN's, not
// 192^-0.5. The bf16 kernel takes the two head dims as template parameters
// (DQK for the Q and K tiles and the score products, DV for the V tiles, the
// PV products and o); every other instance has DQK == DV and is the code it
// was. The (192, 128) instance runs through `flash_fwd_dv`. Its shared memory
// is Q 24 KB + two K tiles 48 KB + two V tiles 32 KB = 104 KB, so two blocks
// still fit an SM. Bound at the DeepSeek-V2-Lite prefill (B=1, T=S=352,
// H=16): q, k, v and o are 352 x 16 x (192 + 192 + 128 + 128) x 2 B = 7.2 MB,
// 2.2 us at 3.35 TB/s; the causal products ~1.1 GFLOP, 1.1 us: bytes bind.
//
// What the design still leaves: no wgmma or
// TMA (not needed while bytes bind), no persistent scheduling (the causal
// tiles are issued heaviest first instead), and at B=1 only 6 x 32 = 192
// blocks, about 1.5 waves on 132 SMs.

#include "bf16_mma.cuh"

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 128;  // threads per block
constexpr float NEG_INF = -1e30f;  // the TPU kernel's mask value

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// --- fp32: FMA units ------------------------------------------------------------

constexpr int PAD = 4;   // floats of padding per staged row

template <int D>
constexpr size_t smem_bytes_f32() {
  return sizeof(float) * ((size_t)(BQ + 2 * BK) * (D + PAD) + (size_t)BQ * (BK + 1));
}

// Stage `BK` rows of D floats into shared rows of stride D + PAD.
// Row r comes from src + (row0 + r) * row_stride; rows r >= n_valid are zero.
template <int D>
__device__ inline void stage_tile(float* dst, const float* __restrict__ src, long row_stride, int row0,
                                  int n_valid, float scale) {
  constexpr int VPR = D / 4;  // float4 loads per row
  for (int i = threadIdx.x; i < BK * VPR; i += NT) {
    const int r = i / VPR;
    const int c = (i % VPR) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_valid) {
      val = *reinterpret_cast<const float4*>(src + (long)(row0 + r) * row_stride + c);
      val = make_float4(val.x * scale, val.y * scale, val.z * scale, val.w * scale);
    }
    *reinterpret_cast<float4*>(dst + r * (D + PAD) + c) = val;
  }
}

// Thread pair (2r, 2r+1) owns query row r: it splits the row's 64 scores by
// key parity and its D accumulators by alternating float4 groups, and
// combines its row max and row sum with one shuffle.
template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const int* __restrict__ lengths, float* __restrict__ o, float* __restrict__ lse,
                     int T_len, int S, int H, int Hkv, int causal, int window, float scale) {
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // [BQ][D + PAD], pre-scaled queries
  float* sk = sq + BQ * (D + PAD);              // [BK][D + PAD]
  float* sv = sk + BK * (D + PAD);              // [BK][D + PAD]
  float* sp = sv + BK * (D + PAD);              // [BQ][BK + 1], probabilities

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int row = tid >> 1;  // query row within the tile
  const int half = tid & 1;  // which half of the row's columns this thread owns
  const int r_glob = q0 + row;
  const int len = max(0, min(lengths[b], S));

  const long q_stride = (long)H * D;
  const long kv_stride = (long)Hkv * D;
  const float* qb = q + ((long)b * T_len * H + h) * D;
  const float* kb = k + ((long)b * S * Hkv + hk) * D;
  const float* vb = v + ((long)b * S * Hkv + hk) * D;

  stage_tile<D>(sq, qb, q_stride, q0, min(BQ, T_len - q0), scale);

  int upper = cdiv(len, BK);
  if (causal) upper = min(cdiv(q0 + BQ, BK), upper);
  int lower = 0;
  if (window > 0) lower = max(0, (q0 - window + 1) / BK);

  constexpr int NG = D / 8;  // float4 accumulator groups per thread
  float acc[4 * NG];
#pragma unroll
  for (int i = 0; i < 4 * NG; ++i) acc[i] = 0.f;
  float m_i = NEG_INF;
  float l_i = 0.f;
  const float* qrow = sq + row * (D + PAD);
  float* prow = sp + row * (BK + 1);

  for (int kt = lower; kt < upper; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's reads of sk/sv are done
    stage_tile<D>(sk, kb, kv_stride, k0, min(BK, len - k0), 1.f);
    stage_tile<D>(sv, vb, kv_stride, k0, min(BK, len - k0), 1.f);
    __syncthreads();

    // Scores for keys k0 + 2j + half.
    float s[BK / 2];
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(sk + (2 * j + half) * (D + PAD) + d);
        s[j] = fmaf(qv.x, kv.x, s[j]);
        s[j] = fmaf(qv.y, kv.y, s[j]);
        s[j] = fmaf(qv.z, kv.z, s[j]);
        s[j] = fmaf(qv.w, kv.w, s[j]);
      }
    }

    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int col = k0 + 2 * j + half;
      bool ok = col < len;
      if (causal) ok = ok && (col <= r_glob);
      if (window > 0) ok = ok && (col > r_glob - window);
      s[j] = ok ? s[j] : NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    const float alpha = expf(m_i - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
      prow[2 * j + half] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l_i = l_i * alpha + psum;
    m_i = m_new;
#pragma unroll
    for (int i = 0; i < 4 * NG; ++i) acc[i] *= alpha;
    __syncwarp();  // a row's probabilities are written and read within one warp

    for (int j = 0; j < BK; ++j) {
      const float p = prow[j];
      const float* vrow = sv + j * (D + PAD);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 vv = *reinterpret_cast<const float4*>(vrow + 4 * (2 * g + half));
        acc[4 * g + 0] = fmaf(p, vv.x, acc[4 * g + 0]);
        acc[4 * g + 1] = fmaf(p, vv.y, acc[4 * g + 1]);
        acc[4 * g + 2] = fmaf(p, vv.z, acc[4 * g + 2]);
        acc[4 * g + 3] = fmaf(p, vv.w, acc[4 * g + 3]);
      }
    }
    __syncwarp();  // reads of prow finish before the next tile overwrites it
  }

  if (r_glob < T_len) {
    const float l_safe = (l_i == 0.f) ? 1.f : l_i;
    float* orow = o + ((long)b * T_len * H + (long)r_glob * H + h) * D;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int d = 4 * (2 * g + half);
#pragma unroll
      for (int c = 0; c < 4; ++c) orow[d + c] = acc[4 * g + c] / l_safe;
    }
    if (half == 0) lse[((long)b * H + h) * T_len + r_glob] = m_i + logf(l_safe);
  }
}

// --- bf16: tensor cores -----------------------------------------------------------

constexpr float LN2 = 0.6931471805599453f;

template <int DQK, int DV = DQK>
constexpr size_t smem_bytes_bf16() {
  return (size_t)3 * 64 * DQK * 2 + (size_t)2 * 64 * DV * 2;  // Q, then K and V twice each
}

// DQK: q's and k's head dim; DV: v's and o's. F32_OUT: `out` is float
// [B, T, H, DV] (a ring block's output, merged in fp32 by the caller), else bf16.
template <int DQK, int DV, bool F32_OUT>
__global__ void __launch_bounds__(NT, 2)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                      const int* __restrict__ lengths, void* __restrict__ out, float* __restrict__ lse, int T_len,
                      int S, int H, int Hkv, int causal, int window, float scale_log2) {
  constexpr int TILE = 64 * DQK * 2;   // bytes of one 64-row Q or K tile
  constexpr int VTILE = 64 * DV * 2;   // bytes of one 64-row V tile
  constexpr int KS = DQK / 16;         // mma k-steps over the head dim
  constexpr int NO = DV / 8;           // output n-tiles per warp
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sK = sQ + TILE;      // buffers sK + buf * TILE
  const uint32_t sV = sK + 2 * TILE;  // buffers sV + buf * VTILE

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest causal rows start first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int len = max(0, min(lengths[b], S));
  const long q_stride = (long)H * DQK, kv_stride = (long)Hkv * DQK, v_stride = (long)Hkv * DV;
  const bf16* qb = q + ((long)b * T_len * H + h) * DQK;
  const bf16* kb = k + ((long)b * S * Hkv + hk) * DQK;
  const bf16* vb = v + ((long)b * S * Hkv + hk) * DV;

  int upper = cdiv(len, BK);
  if (causal) upper = min(cdiv(q0 + BQ, BK), upper);
  int lower = 0;
  if (window > 0) lower = max(0, (q0 - window + 1) / BK);

  load_tile<DQK, NT>(sQ, qb, q_stride, q0, T_len);
  if (lower < upper) {
    load_tile<DQK, NT>(sK, kb, kv_stride, lower * BK, len);
    load_tile<DV, NT>(sV, vb, v_stride, lower * BK, len);
  }
  cp_async_commit();

  const int row_lo = q0 + warp * 16 + g;  // this thread's rows: row_lo and row_lo + 8
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l_run[2] = {0.f, 0.f};               // this thread's share of the row sums
  uint32_t qf[KS][4];

  for (int kt = lower; kt < upper; ++kt) {
    const int buf = (kt - lower) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile kt has landed, and every warp is done with tile kt - 1
    if (kt == lower) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldsm_x4(qf[ks], sQ + swz<DQK>(warp * 16 + (lane & 15), 2 * ks + (lane >> 4)));
    }
    if (kt + 1 < upper) {
      load_tile<DQK, NT>(sK + (buf ^ 1) * TILE, kb, kv_stride, (kt + 1) * BK, len);
      load_tile<DV, NT>(sV + (buf ^ 1) * VTILE, vb, v_stride, (kt + 1) * BK, len);
    }
    cp_async_commit();
    const uint32_t kbuf = sK + buf * TILE, vbuf = sV + buf * VTILE;
    const int k0 = kt * BK;

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {  // keys 16p .. 16p + 15
        uint32_t r[4];
        const int i = lane >> 3;
        ldsm_x4(r, kbuf + swz<DQK>(16 * p + (i >> 1) * 8 + (lane & 7), 2 * ks + (i & 1)));
        mma_bf16(s[2 * p], qf[ks], r[0], r[1]);
        mma_bf16(s[2 * p + 1], qf[ks], r[2], r[3]);
      }
    }

    const bool edge = (k0 + BK > len) || (causal && k0 + BK - 1 > q0) || (window > 0 && k0 <= q0 + BQ - 1 - window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int row = row_lo + (e >> 1) * 8, col = k0 + 8 * j + 2 * t + (e & 1);
          bool ok = col < len;
          if (causal) ok = ok && col <= row;
          if (window > 0) ok = ok && col > row - window;
          x = ok ? x : -INFINITY;
        }
        s[j][e] = x;
      }
    }

    // Online softmax per row (rows g and g + 8; a row's 64 scores sit in one quad).
    float alpha[2], base[2];
#pragma unroll
    for (int hrow = 0; hrow < 2; ++hrow) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hrow], s[j][2 * hrow + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[hrow], mx);
      base[hrow] = (m_new == -INFINITY) ? 0.f : m_new;  // a row with no valid key yet keeps p = 0
      alpha[hrow] = exp2f(m_run[hrow] - base[hrow]);
      m_run[hrow] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - base[e >> 1]);
        psum[e >> 1] += p;
        s[j][e] = p;
      }
    }
#pragma unroll
    for (int hrow = 0; hrow < 2; ++hrow) l_run[hrow] = l_run[hrow] * alpha[hrow] + psum[hrow];
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V: P's accumulator layout is PV's A-fragment layout. With an
    // fp32 output, P enters as a bf16 pair hi + lo (two mma each), as in
    // flash_bwd.cu, so o keeps ~16 bits of P where one rounding keeps 8.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // keys 16kk .. 16kk + 15
      uint32_t pa[4], pl[4];
      split_frag(s, kk, pa, pl);
#pragma unroll
      for (int dp = 0; dp < DV / 16; ++dp) {
        uint32_t r[4];
        const int i = lane >> 3;
        ldsm_x4_t(r, vbuf + swz<DV>(16 * kk + (i & 1) * 8 + (lane & 7), 2 * dp + (i >> 1)));
        mma_bf16(acc[2 * dp], pa, r[0], r[1]);
        mma_bf16(acc[2 * dp + 1], pa, r[2], r[3]);
        if constexpr (F32_OUT) {
          mma_bf16(acc[2 * dp], pl, r[0], r[1]);
          mma_bf16(acc[2 * dp + 1], pl, r[2], r[3]);
        }
      }
    }
  }
  cp_async_wait_all();  // a block with no key tile still has its Q load in flight
  __syncthreads();      // ... issued by every thread, into every warp's rows

  float inv[2];
#pragma unroll
  for (int hrow = 0; hrow < 2; ++hrow) {
    float l = l_run[hrow];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[hrow] = (l == 0.f) ? 0.f : 1.f / l;
    const int row = row_lo + 8 * hrow;
    if (t == 0 && row < T_len)
      lse[((long)b * H + h) * T_len + row] = (l == 0.f) ? NEG_INF : (m_run[hrow] + log2f(l)) * LN2;
  }

  if constexpr (F32_OUT) {
    // fp32: each thread writes its rows' column pairs from registers as 8-byte stores.
    float* o = static_cast<float*>(out);
#pragma unroll
    for (int j = 0; j < NO; ++j) {
#pragma unroll
      for (int hrow = 0; hrow < 2; ++hrow) {
        const int row = row_lo + 8 * hrow;
        if (row < T_len)
          *reinterpret_cast<float2*>(o + ((long)b * T_len * H + (long)row * H + h) * DV + 8 * j + 2 * t) =
              make_float2(acc[j][2 * hrow] * inv[hrow], acc[j][2 * hrow + 1] * inv[hrow]);
      }
    }
    return;
  }
  // bf16: stage the warp's 16 output rows in its own rows of the Q tile (read
  // only by this warp, into registers, before its first key tile; as rows of
  // DV <= DQK), then write them as 16-byte rows.
  bf16* o = static_cast<bf16*>(out);
  uint8_t* sQp = smem;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
#pragma unroll
    for (int hrow = 0; hrow < 2; ++hrow) {
      const int r = warp * 16 + g + 8 * hrow;
      *reinterpret_cast<uint32_t*>(sQp + swz<DV>(r, j) + 4 * t) =
          pack_bf16(acc[j][2 * hrow] * inv[hrow], acc[j][2 * hrow + 1] * inv[hrow]);
    }
  }
  __syncwarp();
  constexpr int CH = DV / 8;
#pragma unroll
  for (int j = 0; j < 16 * CH / 32; ++j) {
    const int i = lane + 32 * j;
    const int r = i / CH, c = i % CH;
    const int row = q0 + warp * 16 + r;
    if (row < T_len)
      *reinterpret_cast<uint4*>(o + ((long)b * T_len * H + (long)row * H + h) * DV + c * 8) =
          *reinterpret_cast<const uint4*>(sQp + swz<DV>(warp * 16 + r, c));
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes, bool& configured) {
  if (configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) configured = true;
  return err;
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* lengths, void* o, void* lse, int B,
                       int T_len, int S, int H, int Hkv, int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes_f32<D>();
  static bool configured = false;
  cudaError_t err = set_smem(flash_fwd_f32_kernel<D>, smem, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(T_len, BQ), H, B);
  flash_fwd_f32_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(lengths), static_cast<float*>(o), static_cast<float*>(lse), T_len, S, H, Hkv,
      causal, window, scale);
  return cudaGetLastError();
}

template <int D, bool F32_OUT, int DV = D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* lengths, void* o, void* lse, int B,
                        int T_len, int S, int H, int Hkv, int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes_bf16<D, DV>();
  static bool configured = false;
  cudaError_t err = set_smem(flash_fwd_bf16_kernel<D, DV, F32_OUT>, smem, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(T_len, BQ), H, B);
  flash_fwd_bf16_kernel<D, DV, F32_OUT><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(lengths), o, static_cast<float*>(lse), T_len, S, H, Hkv, causal, window,
      scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// dtype: the inputs' type, 0 = float32, 1 = bfloat16; out_dtype: o's type,
// the same codes (bf16 inputs may write fp32 o; fp32 inputs write fp32).
// window <= 0 means no window. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* lengths, void* o,
                         void* lse, int B, int T_len, int S, int H, int Hkv, int D, int dtype, int out_dtype,
                         int causal, int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FWD_ARGS q, k, v, lengths, o, lse, B, T_len, S, H, Hkv, causal, window, scale, st
  switch (dtype * 10000 + out_dtype * 1000 + D) {
    case 64: return launch_f32<64>(FWD_ARGS);
    case 80: return launch_f32<80>(FWD_ARGS);
    case 128: return launch_f32<128>(FWD_ARGS);
    case 11064: return launch_bf16<64, false>(FWD_ARGS);
    case 11080: return launch_bf16<80, false>(FWD_ARGS);
    case 11128: return launch_bf16<128, false>(FWD_ARGS);
    case 10064: return launch_bf16<64, true>(FWD_ARGS);
    case 10080: return launch_bf16<80, true>(FWD_ARGS);
    case 10128: return launch_bf16<128, true>(FWD_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FWD_ARGS
}

// The bf16 forward with v's own head dim Dv (o [B, T, H, Dv]): (D, Dv) =
// (192, 128) only, bf16 in and out. Arguments as flash_fwd's, Dv after D.
extern "C" int flash_fwd_dv(const void* q, const void* k, const void* v, const void* lengths, void* o,
                            void* lse, int B, int T_len, int S, int H, int Hkv, int D, int Dv, int dtype,
                            int out_dtype, int causal, int window, float scale, void* stream) {
  if (D != 192 || Dv != 128 || dtype != 1 || out_dtype != 1) return (int)cudaErrorInvalidValue;
  return launch_bf16<192, false, 128>(q, k, v, lengths, o, lse, B, T_len, S, H, Hkv, causal, window, scale,
                                       static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of one block (bytes), for the build report.
extern "C" int flash_fwd_smem_bytes(int D, int dtype) {
  switch (D) {
    case 64: return (int)(dtype == 1 ? smem_bytes_bf16<64>() : smem_bytes_f32<64>());
    case 80: return (int)(dtype == 1 ? smem_bytes_bf16<80>() : smem_bytes_f32<80>());
    case 128: return (int)(dtype == 1 ? smem_bytes_bf16<128>() : smem_bytes_f32<128>());
    default: return -1;
  }
}
