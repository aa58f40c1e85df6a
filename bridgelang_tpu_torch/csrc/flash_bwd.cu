// Flash-attention backward for Hopper (sm_90a), plain C interface: two kernels.
//
// Replaces bridgelang_tpu/ops/flash_attention.py::_bwd_dq_kernel (launched
// from `_dq_pallas`) and ::_bwd_dkv_kernel (launched from `_dkv_pallas`), the
// Pallas TPU kernels behind the custom VJP of `flash_attention`. Same
// function: P = exp(scale q.k^T - lse) under the forward's mask (causal,
// per-example `lengths`, optional window, keys at least as long as
// queries), dP = dO.v^T, dS = P * (dP - delta) with delta = rowsum(dO * O)
// computed by the caller, and
//   dq = scale dS.k           (flash_bwd_dq)
//   dv = P^T.dO, dk = scale dS^T.q  (flash_bwd_dkv).
// GQA: query head h reads KV head h / (H / Hkv). The TPU kernel writes dk/dv
// per query head in f32 and sums the groups outside (_flash_bwd, :456); here
// one block per KV head loops over the heads of its group and accumulates in
// fp32 registers, so there is no f32 [B, H, S, D] scratch and each output is
// written once, in k's type (or in fp32 from bf16 inputs, `out_dtype`: a ring
// block's share, which the ring sums in fp32 and rounds once, as the JAX
// ring's fp32 gradients are). Key slots at or past `lengths` get exactly zero
// gradient: their rows are zero-filled in shared memory, never read, so a
// non-finite dead cache slot cannot leak through a zero probability.
//
// Layouts are the public API's and are read in place: q/dO/dq [B, T, H, D],
// k/v/dk/dv [B, S, Hkv, D], lse/delta f32 [B, H, T], all contiguous.
//
// bf16: FlashAttention-2's backward on the tensor cores, two kernels (no
// atomics, so every run sums in the same order). Every product runs on
// mma.sync m16n8k16 (bf16 in, fp32 sums), its operands loaded with ldmatrix
// (.trans where the product runs along the tile's rows) from tiles swizzled
// by 16-byte chunk; tiles arrive through a cp.async double buffer whose
// src-size-0 form zero-fills rows past the valid length or past T, so the
// next tile's loads overlap this tile's products. Scores are scaled with
// log2(e) folded in and exponentiated with exp2f; masks run only on tiles
// that cross an edge. 4 warps per block; outputs are staged through shared
// memory and written as 16-byte stores. The building blocks are
// bf16_mma.cuh's, shared with flash_fwd.cu.
//   dq:  one block per (64-query tile, head, example), heaviest causal tile
//        first. Each warp owns 16 query rows; Q's fragments stay in
//        registers, dO's are read from its tile. Per 64-key tile, in two
//        halves of 32 keys: S = QK^T and dP = dO V^T in registers, P and dS
//        in place, then dQ += dS K with K read transposed.
//   dkv: one block per (64-key tile, KV head, example), key tile 0 (the
//        heaviest) first; the block loops over the group's heads and, for
//        each, over the query tiles in the forward's bounds
//        (flash_attention.py:170-176), with Q, dO, lse and delta in the
//        double buffer. Each warp owns 16 keys and all D columns of their
//        dK and dV (128 fp32 registers at D = 128). Per query tile, in two
//        halves of 32 rows: S^T = K Q^T and dP^T = V dO^T, then dV += P^T dO
//        and dK += dS^T Q with dO and Q read transposed.
// P and dS enter their products as bf16 pairs hi + lo (hi = bf16(x),
// lo = bf16(x - hi)), two mma each, so they carry ~16 bits where one bf16
// rounding carries 8. Q, K, V and dO are bf16 already, so S and dP need no
// split. One rounding is what FlashAttention-2 and SDPA do, and it fails
// this port's gradient rule (chip_smoke.GRAD_TOL: one bf16 ulp of the plain
// fp32 backward plus 1e-3 rms, set to catch a dropped tile). Modelled on the
// plain backward at bf16 inputs (seeds 60-62), one rounding uses 4.7-15
// times the tolerance at B=1, T=192, D=64 and 11-25 times at B=2, T=352,
// H=8, D=128; the pair 0.63-0.79 and 0.86-0.94
// (tests/test_torch_flash_backward.py pins both on the CPU).
//
// fp32: the products on the FMA units (64-row tiles staged as fp32, four
// threads per row), kept for the card-vs-CPU fp32 parity run, which needs
// fp32 products, as flash_fwd.cu's fp32 kernel.
//
// Bound at the training shape (B=16, T=S=352, H=32, D=128, bf16, lengths
// 352-266; chip_smoke.bwd_bound_ms): dq reads q, k, v, dO, lse and delta
// and writes dq, 0.0693 ms at 3.35 TB/s; dk/dv read the same and write dk
// and dv, 0.0831 ms. Their products, 6 D (dq) and 8 D (dk/dv) FLOPs per
// attended pair, take ~0.03 ms at the 989 TFLOP/s bf16 peak, so both are
// bound by bytes. The hi + lo split adds 2 D FLOPs per pair and product on
// the tensor cores, and P and S are recomputed in both kernels. What the
// design still leaves: mma.sync instead of wgmma and cp.async instead of
// TMA; the recomputation of S and dP in both kernels (FlashAttention-2's
// single pass needs an atomic fp32 dq); each dkv warp re-reads its K and V
// fragments from shared memory for every query tile; and delta is a
// separate torch reduction before the kernels.

#include "bf16_mma.cuh"

namespace {

constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per block: four per tile row
constexpr int PAD = 4;   // floats of padding per staged row

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// Stage 64 rows of D floats into shared rows of stride D + PAD.
// Row r comes from src + (row0 + r) * row_stride, times `scale`; rows
// r >= n_valid are zero.
template <int D>
__device__ inline void stage_tile(float* dst, const float* __restrict__ src, long row_stride, int row0,
                                  int n_valid, float scale) {
  constexpr int VPR = D / 4;  // float4 loads per row
  for (int i = threadIdx.x; i < 64 * VPR; i += NT) {
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

__device__ inline bool attended(int row, int col, int len, int causal, int window) {
  bool ok = col < len;
  if (causal) ok = ok && (col <= row);
  if (window > 0) ok = ok && (col > row - window);
  return ok;
}

// dot products of one staged row `a` with 16 staged rows b[sub + 4i], and of
// row `c` with rows e[sub + 4i], in one pass over D.
template <int D>
__device__ inline void dots16(const float* a, const float* b, const float* c, const float* e, int sub,
                              float (&ab)[16], float (&ce)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) ab[i] = ce[i] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    const float4 av = *reinterpret_cast<const float4*>(a + d);
    const float4 cv = *reinterpret_cast<const float4*>(c + d);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float4 bv = *reinterpret_cast<const float4*>(b + (sub + 4 * i) * (D + PAD) + d);
      const float4 ev = *reinterpret_cast<const float4*>(e + (sub + 4 * i) * (D + PAD) + d);
      ab[i] = fmaf(av.x, bv.x, ab[i]);
      ab[i] = fmaf(av.y, bv.y, ab[i]);
      ab[i] = fmaf(av.z, bv.z, ab[i]);
      ab[i] = fmaf(av.w, bv.w, ab[i]);
      ce[i] = fmaf(cv.x, ev.x, ce[i]);
      ce[i] = fmaf(cv.y, ev.y, ce[i]);
      ce[i] = fmaf(cv.z, ev.z, ce[i]);
      ce[i] = fmaf(cv.w, ev.w, ce[i]);
    }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * ((size_t)(BQ * 2 + BK * 2) * (D + PAD) + (size_t)BQ * (BK + 1));
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ lengths, float* __restrict__ dq, int T_len, int S, int H, int Hkv,
                    int causal, int window, float scale) {
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // [BQ][D + PAD], pre-scaled queries
  float* sdo = sq + BQ * (D + PAD);             // [BQ][D + PAD]
  float* sk = sdo + BQ * (D + PAD);             // [BK][D + PAD]
  float* sv = sk + BK * (D + PAD);              // [BK][D + PAD]
  float* sds = sv + BK * (D + PAD);             // [BQ][BK + 1], dS

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int row = threadIdx.x >> 2;  // query row within the tile
  const int sub = threadIdx.x & 3;   // which quarter of the row's keys and columns
  const int r_glob = q0 + row;
  const int len = max(0, min(lengths[b], S));

  const long q_stride = (long)H * D;
  const long kv_stride = (long)Hkv * D;
  const long q_off = ((long)b * T_len * H + h) * D;
  const float* kb = k + ((long)b * S * Hkv + hk) * D;
  const float* vb = v + ((long)b * S * Hkv + hk) * D;
  const int n_rows = min(BQ, T_len - q0);

  stage_tile<D>(sq, q + q_off, q_stride, q0, n_rows, scale);
  stage_tile<D>(sdo, dout + q_off, q_stride, q0, n_rows, 1.f);
  const long stat = ((long)b * H + h) * T_len + r_glob;
  const float lse_r = r_glob < T_len ? lse[stat] : 0.f;
  const float delta_r = r_glob < T_len ? delta[stat] : 0.f;

  int upper = cdiv(len, BK);
  if (causal) upper = min(cdiv(q0 + BQ, BK), upper);
  int lower = 0;
  if (window > 0) lower = max(0, (q0 - window + 1) / BK);

  constexpr int NG = D / 16;  // float4 column groups per thread
  float acc[4 * NG];
#pragma unroll
  for (int i = 0; i < 4 * NG; ++i) acc[i] = 0.f;
  const float* qrow = sq + row * (D + PAD);
  const float* dorow = sdo + row * (D + PAD);
  float* dsrow = sds + row * (BK + 1);

  for (int kt = lower; kt < upper; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's reads of sk/sv are done
    stage_tile<D>(sk, kb, kv_stride, k0, min(BK, len - k0), 1.f);
    stage_tile<D>(sv, vb, kv_stride, k0, min(BK, len - k0), 1.f);
    __syncthreads();

    float s[16], dp[16];
    dots16<D>(qrow, sk, dorow, sv, sub, s, dp);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int j = sub + 4 * i;
      const bool ok = r_glob < T_len && attended(r_glob, k0 + j, len, causal, window);
      const float p = ok ? expf(s[i] - lse_r) : 0.f;
      dsrow[j] = p * (dp[i] - delta_r);
    }
    __syncwarp();  // a row's dS is written and read within one warp

    for (int j = 0; j < BK; ++j) {
      const float ds = dsrow[j];
      const float* krow = sk + j * (D + PAD);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 kv = *reinterpret_cast<const float4*>(krow + 4 * (4 * g + sub));
        acc[4 * g + 0] = fmaf(ds, kv.x, acc[4 * g + 0]);
        acc[4 * g + 1] = fmaf(ds, kv.y, acc[4 * g + 1]);
        acc[4 * g + 2] = fmaf(ds, kv.z, acc[4 * g + 2]);
        acc[4 * g + 3] = fmaf(ds, kv.w, acc[4 * g + 3]);
      }
    }
    __syncwarp();  // reads of dsrow finish before the next tile overwrites it
  }

  if (r_glob < T_len) {
    float* out = dq + q_off + (long)r_glob * q_stride;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int d = 4 * (4 * g + sub);
#pragma unroll
      for (int c = 0; c < 4; ++c) out[d + c] = acc[4 * g + c] * scale;
    }
  }
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * ((size_t)(BK * 2 + BQ * 2) * (D + PAD) + (size_t)2 * BK * (BQ + 1) + 2 * BQ);
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ lengths, float* __restrict__ dk, float* __restrict__ dv, int T_len, int S,
                     int H, int Hkv, int causal, int window, float scale) {
  extern __shared__ float4 smem4[];
  float* sk = reinterpret_cast<float*>(smem4);  // [BK][D + PAD]
  float* sv = sk + BK * (D + PAD);              // [BK][D + PAD]
  float* sq = sv + BK * (D + PAD);              // [BQ][D + PAD], pre-scaled queries
  float* sdo = sq + BQ * (D + PAD);             // [BQ][D + PAD]
  float* sp = sdo + BQ * (D + PAD);             // [BK][BQ + 1], P transposed
  float* sds = sp + BK * (BQ + 1);              // [BK][BQ + 1], dS transposed
  float* slse = sds + BK * (BQ + 1);            // [BQ]
  float* sdelta = slse + BQ;                    // [BQ]

  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / Hkv;
  const int key = threadIdx.x >> 2;  // key row within the tile
  const int sub = threadIdx.x & 3;   // which quarter of the query rows and columns
  const int c_glob = k0 + key;
  const int len = max(0, min(lengths[b], S));

  const long q_stride = (long)H * D;
  const long kv_stride = (long)Hkv * D;
  const long kv_off = ((long)b * S * Hkv + hk) * D;

  stage_tile<D>(sk, k + kv_off, kv_stride, k0, min(BK, len - k0), 1.f);
  stage_tile<D>(sv, v + kv_off, kv_stride, k0, min(BK, len - k0), 1.f);

  const int n_qt = cdiv(T_len, BQ);
  int lower = causal ? k0 / BQ : 0;
  int upper = n_qt;
  if (window > 0) upper = min(n_qt, (k0 + BK + window - 2) / BQ + 1);
  if (k0 >= len) upper = lower;  // every key of the tile is dead: zero gradient

  constexpr int NG = D / 16;  // float4 column groups per thread
  float dk_acc[4 * NG], dv_acc[4 * NG];
#pragma unroll
  for (int i = 0; i < 4 * NG; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const float* krow = sk + key * (D + PAD);
  const float* vrow = sv + key * (D + PAD);
  float* prow = sp + key * (BQ + 1);
  float* dsrow = sds + key * (BQ + 1);

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const long q_off = ((long)b * T_len * H + h) * D;
    for (int qt = lower; qt < upper; ++qt) {
      const int q0 = qt * BQ;
      const int n_rows = min(BQ, T_len - q0);
      __syncthreads();  // the previous tile's reads of sq/sdo/slse/sdelta are done
      stage_tile<D>(sq, q + q_off, q_stride, q0, n_rows, scale);
      stage_tile<D>(sdo, dout + q_off, q_stride, q0, n_rows, 1.f);
      if (threadIdx.x < BQ) {
        const long stat = ((long)b * H + h) * T_len + q0 + threadIdx.x;
        slse[threadIdx.x] = threadIdx.x < n_rows ? lse[stat] : 0.f;
        sdelta[threadIdx.x] = threadIdx.x < n_rows ? delta[stat] : 0.f;
      }
      __syncthreads();

      float s[16], dp[16];
      dots16<D>(krow, sq, vrow, sdo, sub, s, dp);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = sub + 4 * i;
        const bool ok = r < n_rows && attended(q0 + r, c_glob, len, causal, window);
        const float p = ok ? expf(s[i] - slse[r]) : 0.f;
        prow[r] = p;
        dsrow[r] = p * (dp[i] - sdelta[r]);
      }
      __syncwarp();  // a key's P and dS are written and read within one warp

      for (int r = 0; r < BQ; ++r) {
        const float p = prow[r];
        const float ds = dsrow[r];
        const float* qrow = sq + r * (D + PAD);
        const float* dorow = sdo + r * (D + PAD);
#pragma unroll
        for (int c = 0; c < NG; ++c) {
          const int d = 4 * (4 * c + sub);
          const float4 qv = *reinterpret_cast<const float4*>(qrow + d);
          const float4 dov = *reinterpret_cast<const float4*>(dorow + d);
          dv_acc[4 * c + 0] = fmaf(p, dov.x, dv_acc[4 * c + 0]);
          dv_acc[4 * c + 1] = fmaf(p, dov.y, dv_acc[4 * c + 1]);
          dv_acc[4 * c + 2] = fmaf(p, dov.z, dv_acc[4 * c + 2]);
          dv_acc[4 * c + 3] = fmaf(p, dov.w, dv_acc[4 * c + 3]);
          dk_acc[4 * c + 0] = fmaf(ds, qv.x, dk_acc[4 * c + 0]);
          dk_acc[4 * c + 1] = fmaf(ds, qv.y, dk_acc[4 * c + 1]);
          dk_acc[4 * c + 2] = fmaf(ds, qv.z, dk_acc[4 * c + 2]);
          dk_acc[4 * c + 3] = fmaf(ds, qv.w, dk_acc[4 * c + 3]);
        }
      }
      __syncwarp();  // reads of prow/dsrow finish before the next tile overwrites them
    }
  }

  if (c_glob < S) {
    const long out = kv_off + (long)c_glob * kv_stride;
#pragma unroll
    for (int c = 0; c < NG; ++c) {
      const int d = 4 * (4 * c + sub);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dk[out + d + e] = dk_acc[4 * c + e];
        dv[out + d + e] = dv_acc[4 * c + e];
      }
    }
  }
}


// --- bf16: tensor cores -------------------------------------------------------------

constexpr int TC_NT = 128;  // threads of a bf16 block: 4 warps

template <int D>
constexpr size_t dq_bf16_smem_bytes() {
  return (size_t)6 * 64 * D * 2;  // Q, dO, then K and V twice each
}

// F32_OUT: `dq_out` is float [B, T, H, D], else bf16.
template <int D, bool F32_OUT>
__global__ void __launch_bounds__(TC_NT, 2)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                         const bf16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, const int* __restrict__ lengths, void* __restrict__ dq_out,
                         int T_len, int S, int H, int Hkv, int causal, int window, float scale) {
  constexpr int TILE = 64 * D * 2;  // bytes of one 64-row tile
  constexpr int KS = D / 16;        // mma k-steps over the head dim
  constexpr int NO = D / 8;         // dq n-tiles per warp
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sdO = sQ + TILE;
  const uint32_t sK = sdO + TILE;     // buffers sK + buf * TILE
  const uint32_t sV = sK + 2 * TILE;  // buffers sV + buf * TILE

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest causal rows start first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3;  // mi: the 8x8 matrix this lane addresses in ldmatrix
  const int len = max(0, min(lengths[b], S));
  const long q_stride = (long)H * D, kv_stride = (long)Hkv * D;
  const long q_off = ((long)b * T_len * H + h) * D;
  const bf16* kb = k + ((long)b * S * Hkv + hk) * D;
  const bf16* vb = v + ((long)b * S * Hkv + hk) * D;
  const float scale_log2 = scale * LOG2E;

  int upper = cdiv(len, BK);
  if (causal) upper = min(cdiv(q0 + BQ, BK), upper);
  int lower = 0;
  if (window > 0) lower = max(0, (q0 - window + 1) / BK);

  load_tile<D, TC_NT>(sQ, q + q_off, q_stride, q0, T_len);
  load_tile<D, TC_NT>(sdO, dout + q_off, q_stride, q0, T_len);
  if (lower < upper) {
    load_tile<D, TC_NT>(sK, kb, kv_stride, lower * BK, len);
    load_tile<D, TC_NT>(sV, vb, kv_stride, lower * BK, len);
  }
  cp_async_commit();

  const int row_lo = q0 + warp * 16 + g;  // this thread's rows: row_lo and row_lo + 8
  float lse2[2], dlt[2];                  // lse in log2 units and delta; 0 past T
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row_lo + 8 * hr;
    const long stat = ((long)b * H + h) * T_len + row;
    lse2[hr] = row < T_len ? lse[stat] * LOG2E : 0.f;
    dlt[hr] = row < T_len ? delta[stat] : 0.f;
  }
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  uint32_t qf[KS][4];

  for (int kt = lower; kt < upper; ++kt) {
    const int buf = (kt - lower) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile kt has landed, and every warp is done with tile kt - 1
    if (kt == lower) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldsm_x4(qf[ks], sQ + swz<D>(warp * 16 + (lane & 15), 2 * ks + (lane >> 4)));
    }
    if (kt + 1 < upper) {
      load_tile<D, TC_NT>(sK + (buf ^ 1) * TILE, kb, kv_stride, (kt + 1) * BK, len);
      load_tile<D, TC_NT>(sV + (buf ^ 1) * TILE, vb, kv_stride, (kt + 1) * BK, len);
    }
    cp_async_commit();
    const uint32_t kbuf = sK + buf * TILE, vbuf = sV + buf * TILE;
    const int k0 = kt * BK;
    const bool edge = (k0 + BK > len) || (causal && k0 + BK - 1 > q0) || (window > 0 && k0 <= q0 + BQ - 1 - window);

#pragma unroll 1
    for (int kh = 0; kh < 2; ++kh) {  // keys k0 + 32 kh .. k0 + 32 kh + 31
      // S = Q K^T and dP = dO V^T: 16 rows x 32 keys per warp, 4 n-tiles of 8 keys.
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t of[4];
        ldsm_x4(of, sdO + swz<D>(warp * 16 + (lane & 15), 2 * ks + (lane >> 4)));
#pragma unroll
        for (int p = 0; p < 2; ++p) {  // keys 32 kh + 16 p .. + 15
          const int key = 32 * kh + 16 * p + (mi >> 1) * 8 + (lane & 7);
          uint32_t r[4];
          ldsm_x4(r, kbuf + swz<D>(key, 2 * ks + (mi & 1)));
          mma_bf16(s[2 * p], qf[ks], r[0], r[1]);
          mma_bf16(s[2 * p + 1], qf[ks], r[2], r[3]);
          ldsm_x4(r, vbuf + swz<D>(key, 2 * ks + (mi & 1)));
          mma_bf16(dp[2 * p], of, r[0], r[1]);
          mma_bf16(dp[2 * p + 1], of, r[2], r[3]);
        }
      }
      // P = exp2(S scale log2(e) - lse log2(e)), zero where masked; dS = P (dP - delta), in place of S.
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(s[j][e], scale_log2, -lse2[e >> 1]));
          if (edge) {
            const int row = row_lo + 8 * (e >> 1), col = k0 + 32 * kh + 8 * j + 2 * t + (e & 1);
            p = attended(row, col, len, causal, window) ? p : 0.f;
          }
          s[j][e] = p * (dp[j][e] - dlt[e >> 1]);
        }
      }
      // dQ += dS K: dS as bf16 hi + lo A fragments, K read transposed.
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t hi[4], lo[4];
        split_frag(s, kk, hi, lo);
#pragma unroll
        for (int dd = 0; dd < D / 16; ++dd) {
          uint32_t r[4];
          ldsm_x4_t(r, kbuf + swz<D>(32 * kh + 16 * kk + (mi & 1) * 8 + (lane & 7), 2 * dd + (mi >> 1)));
          mma_bf16(acc[2 * dd], hi, r[0], r[1]);
          mma_bf16(acc[2 * dd], lo, r[0], r[1]);
          mma_bf16(acc[2 * dd + 1], hi, r[2], r[3]);
          mma_bf16(acc[2 * dd + 1], lo, r[2], r[3]);
        }
      }
    }
  }
  cp_async_wait_all();  // a block with no key tile still has its Q and dO loads in flight
  __syncthreads();      // ... issued by every thread, into every warp's rows

  if constexpr (F32_OUT) {
    // fp32: each thread writes its rows' column pairs from registers as 8-byte stores.
    float* dq = static_cast<float*>(dq_out);
#pragma unroll
    for (int j = 0; j < NO; ++j) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = row_lo + 8 * hr;
        if (row < T_len)
          *reinterpret_cast<float2*>(dq + q_off + (long)row * q_stride + 8 * j + 2 * t) =
              make_float2(acc[j][2 * hr] * scale, acc[j][2 * hr + 1] * scale);
      }
    }
    return;
  }
  // bf16: stage the warp's 16 dq rows in its own rows of the Q tile, then write them as 16-byte rows.
  bf16* dq = static_cast<bf16*>(dq_out);
  uint8_t* sQp = smem;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = warp * 16 + g + 8 * hr;
      *reinterpret_cast<uint32_t*>(sQp + swz<D>(r, j) + 4 * t) =
          pack_bf16(acc[j][2 * hr] * scale, acc[j][2 * hr + 1] * scale);
    }
  }
  __syncwarp();
  constexpr int CH = D / 8;
#pragma unroll
  for (int j = 0; j < 16 * CH / 32; ++j) {
    const int i = lane + 32 * j;
    const int r = i / CH, c = i % CH;
    const int row = q0 + warp * 16 + r;
    if (row < T_len)
      *reinterpret_cast<uint4*>(dq + q_off + (long)row * q_stride + c * 8) =
          *reinterpret_cast<const uint4*>(sQp + swz<D>(warp * 16 + r, c));
  }
}

template <int D>
constexpr size_t dkv_bf16_smem_bytes() {
  return (size_t)6 * 64 * D * 2 + 4 * BQ * sizeof(float);  // K, V, then Q and dO twice each; lse, delta twice each
}

// cp.async one query tile of head h into a buffer: Q and dO rows q0 ..
// q0 + 63, and their lse and delta ([lse BQ][delta BQ] floats at sstat),
// zero-filled past T.
template <int D>
__device__ __forceinline__ void load_query_tile(uint32_t sq, uint32_t sdo, uint32_t sstat, const bf16* __restrict__ q,
                                                const bf16* __restrict__ dout, const float* __restrict__ lse,
                                                const float* __restrict__ delta, int b, int h, int q0, int T_len,
                                                int H) {
  const long q_off = ((long)b * T_len * H + h) * D;
  load_tile<D, TC_NT>(sq, q + q_off, (long)H * D, q0, T_len);
  load_tile<D, TC_NT>(sdo, dout + q_off, (long)H * D, q0, T_len);
  if (threadIdx.x < BQ) {
    const int row = q0 + threadIdx.x;
    const bool ok = row < T_len;
    const long stat = ok ? ((long)b * H + h) * T_len + row : 0;
    cp_async4(sstat + 4 * threadIdx.x, lse + stat, ok);
    cp_async4(sstat + 4 * (BQ + threadIdx.x), delta + stat, ok);
  }
}

// F32_OUT: `dk_out` and `dv_out` are float [B, S, Hkv, D], else bf16.
template <int D, bool F32_OUT>
__global__ void __launch_bounds__(TC_NT, 2)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                          const bf16* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ delta, const int* __restrict__ lengths, void* __restrict__ dk_out,
                          void* __restrict__ dv_out, int T_len, int S, int H, int Hkv, int causal, int window,
                          float scale) {
  constexpr int TILE = 64 * D * 2;  // bytes of one 64-row tile
  constexpr int KS = D / 16;        // mma k-steps over the head dim
  constexpr int NO = D / 8;         // dk and dv n-tiles per warp
  constexpr int STAT = 2 * BQ * 4;  // bytes of one buffer's lse and delta
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sK = smem_u32(smem);
  const uint32_t sV = sK + TILE;
  const uint32_t sQ = sV + TILE;       // buffers sQ + buf * TILE
  const uint32_t sdO = sQ + 2 * TILE;  // buffers sdO + buf * TILE
  const uint32_t sStat = sK + 6 * TILE;  // buffers sStat + buf * STAT
  const float* stats = reinterpret_cast<const float*>(smem + 6 * TILE);

  const int k0 = blockIdx.x * BK;  // key tile 0, the heaviest under causal masking, starts first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3;  // mi: the 8x8 matrix this lane addresses in ldmatrix
  const int len = max(0, min(lengths[b], S));
  const long kv_stride = (long)Hkv * D;
  const long kv_off = ((long)b * S * Hkv + hk) * D;
  const float scale_log2 = scale * LOG2E;

  const int n_qt = cdiv(T_len, BQ);
  int lower = causal ? k0 / BQ : 0;
  int upper = n_qt;
  if (window > 0) upper = min(n_qt, (k0 + BK + window - 2) / BQ + 1);
  if (k0 >= len) upper = lower;  // every key of the tile is dead: zero gradient
  const int nq = max(0, upper - lower);
  const int n_iter = group * nq;  // (head, query tile) pairs, heads outer

  load_tile<D, TC_NT>(sK, k + kv_off, kv_stride, k0, len);
  load_tile<D, TC_NT>(sV, v + kv_off, kv_stride, k0, len);
  if (n_iter > 0) load_query_tile<D>(sQ, sdO, sStat, q, dout, lse, delta, b, hk * group, lower * BQ, T_len, H);
  cp_async_commit();

  const int key_lo = k0 + warp * 16 + g;  // this thread's keys: key_lo and key_lo + 8
  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
    dka[j][0] = dka[j][1] = dka[j][2] = dka[j][3] = dva[j][0] = dva[j][1] = dva[j][2] = dva[j][3] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    const int buf = it & 1;
    cp_async_wait_all();
    __syncthreads();  // tile it has landed, and every warp is done with tile it - 1
    if (it + 1 < n_iter)
      load_query_tile<D>(sQ + (buf ^ 1) * TILE, sdO + (buf ^ 1) * TILE, sStat + (buf ^ 1) * STAT, q, dout, lse,
                         delta, b, hk * group + (it + 1) / nq, (lower + (it + 1) % nq) * BQ, T_len, H);
    cp_async_commit();
    const int q0 = (lower + it % nq) * BQ;
    const uint32_t qbuf = sQ + buf * TILE, obuf = sdO + buf * TILE;
    const float* slse = stats + buf * 2 * BQ;
    const float* sdl = slse + BQ;
    const bool edge = (k0 + BK > len) || (q0 + BQ > T_len) || (causal && k0 + BK - 1 > q0) ||
                      (window > 0 && k0 <= q0 + BQ - 1 - window);

#pragma unroll 1
    for (int qh = 0; qh < 2; ++qh) {  // query rows q0 + 32 qh .. q0 + 32 qh + 31
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 query rows per warp, 4 n-tiles of 8 rows.
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ka[4], va[4];
        ldsm_x4(ka, sK + swz<D>(warp * 16 + (lane & 15), 2 * ks + (lane >> 4)));
        ldsm_x4(va, sV + swz<D>(warp * 16 + (lane & 15), 2 * ks + (lane >> 4)));
#pragma unroll
        for (int p = 0; p < 2; ++p) {  // query rows 32 qh + 16 p .. + 15
          const int row = 32 * qh + 16 * p + (mi >> 1) * 8 + (lane & 7);
          uint32_t r[4];
          ldsm_x4(r, qbuf + swz<D>(row, 2 * ks + (mi & 1)));
          mma_bf16(s[2 * p], ka, r[0], r[1]);
          mma_bf16(s[2 * p + 1], ka, r[2], r[3]);
          ldsm_x4(r, obuf + swz<D>(row, 2 * ks + (mi & 1)));
          mma_bf16(dp[2 * p], va, r[0], r[1]);
          mma_bf16(dp[2 * p + 1], va, r[2], r[3]);
        }
      }
      // P^T, and dS^T = P^T (dP^T - delta) in place of dP^T: element (key key_lo + 8 (e >> 1), row q0 + c).
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 32 * qh + 8 * j + 2 * t + (e & 1);
          float p = exp2f(fmaf(s[j][e], scale_log2, -slse[c] * LOG2E));
          if (edge) {
            const bool ok = q0 + c < T_len && attended(q0 + c, key_lo + 8 * (e >> 1), len, causal, window);
            p = ok ? p : 0.f;
          }
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - sdl[c]);
        }
      }
      // dV += P^T dO and dK += dS^T Q: P^T and dS^T as bf16 hi + lo A fragments, dO and Q read transposed.
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t ph[4], pl[4], dh[4], dl[4];
        split_frag(s, kk, ph, pl);
        split_frag(dp, kk, dh, dl);
#pragma unroll
        for (int dd = 0; dd < D / 16; ++dd) {
          const uint32_t off = swz<D>(32 * qh + 16 * kk + (mi & 1) * 8 + (lane & 7), 2 * dd + (mi >> 1));
          uint32_t r[4];
          ldsm_x4_t(r, obuf + off);
          mma_bf16(dva[2 * dd], ph, r[0], r[1]);
          mma_bf16(dva[2 * dd], pl, r[0], r[1]);
          mma_bf16(dva[2 * dd + 1], ph, r[2], r[3]);
          mma_bf16(dva[2 * dd + 1], pl, r[2], r[3]);
          ldsm_x4_t(r, qbuf + off);
          mma_bf16(dka[2 * dd], dh, r[0], r[1]);
          mma_bf16(dka[2 * dd], dl, r[0], r[1]);
          mma_bf16(dka[2 * dd + 1], dh, r[2], r[3]);
          mma_bf16(dka[2 * dd + 1], dl, r[2], r[3]);
        }
      }
    }
  }
  cp_async_wait_all();  // a block with no query tile still has its K and V loads in flight
  __syncthreads();      // ... issued by every thread, into every warp's rows

  if constexpr (F32_OUT) {
    // fp32: each thread writes its keys' column pairs from registers as 8-byte stores.
    float* dk = static_cast<float*>(dk_out);
    float* dv = static_cast<float*>(dv_out);
#pragma unroll
    for (int j = 0; j < NO; ++j) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int key = key_lo + 8 * hr;
        if (key < S) {
          const long out = kv_off + (long)key * kv_stride + 8 * j + 2 * t;
          *reinterpret_cast<float2*>(dk + out) = make_float2(dka[j][2 * hr] * scale, dka[j][2 * hr + 1] * scale);
          *reinterpret_cast<float2*>(dv + out) = make_float2(dva[j][2 * hr], dva[j][2 * hr + 1]);
        }
      }
    }
    return;
  }
  // bf16: stage the warp's 16 dk and dv rows in its own rows of the K and V tiles, then write them as 16-byte rows.
  bf16* dk = static_cast<bf16*>(dk_out);
  bf16* dv = static_cast<bf16*>(dv_out);
  uint8_t* sKp = smem;
  uint8_t* sVp = smem + TILE;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const uint32_t off = swz<D>(warp * 16 + g + 8 * hr, j) + 4 * t;
      *reinterpret_cast<uint32_t*>(sKp + off) = pack_bf16(dka[j][2 * hr] * scale, dka[j][2 * hr + 1] * scale);
      *reinterpret_cast<uint32_t*>(sVp + off) = pack_bf16(dva[j][2 * hr], dva[j][2 * hr + 1]);
    }
  }
  __syncwarp();
  constexpr int CH = D / 8;
#pragma unroll
  for (int j = 0; j < 16 * CH / 32; ++j) {
    const int i = lane + 32 * j;
    const int r = i / CH, c = i % CH;
    const int key = k0 + warp * 16 + r;
    if (key < S) {
      const long out = kv_off + (long)key * kv_stride + c * 8;
      const uint32_t off = swz<D>(warp * 16 + r, c);
      *reinterpret_cast<uint4*>(dk + out) = *reinterpret_cast<const uint4*>(sKp + off);
      *reinterpret_cast<uint4*>(dv + out) = *reinterpret_cast<const uint4*>(sVp + off);
    }
  }
}

// --- launchers -------------------------------------------------------------------------

template <typename KernelT>
cudaError_t allow_smem(KernelT kernel, size_t smem, bool& configured) {
  if (configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) configured = true;
  return err;
}

template <int D>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                          const void* delta, const void* lengths, void* dq, int B, int T_len, int S, int H, int Hkv,
                          int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  static bool configured = false;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D>, smem, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(T_len, BQ), H, B);
  flash_bwd_dq_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(lengths), static_cast<float*>(dq), T_len, S, H, Hkv, causal, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                           const void* delta, const void* lengths, void* dk, void* dv, int B, int T_len, int S, int H,
                           int Hkv, int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  static bool configured = false;
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<D>, smem, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(S, BK), Hkv, B);
  flash_bwd_dkv_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(lengths), static_cast<float*>(dk), static_cast<float*>(dv), T_len, S, H, Hkv, causal,
      window, scale);
  return cudaGetLastError();
}

template <int D, bool F32_OUT>
cudaError_t launch_dq_bf16(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                           const void* delta, const void* lengths, void* dq, int B, int T_len, int S, int H, int Hkv,
                           int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = dq_bf16_smem_bytes<D>();
  static bool configured = false;
  cudaError_t err = allow_smem(flash_bwd_dq_bf16_kernel<D, F32_OUT>, smem, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(T_len, BQ), H, B);
  flash_bwd_dq_bf16_kernel<D, F32_OUT><<<grid, TC_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(lengths), dq, T_len, S, H, Hkv, causal, window, scale);
  return cudaGetLastError();
}

template <int D, bool F32_OUT>
cudaError_t launch_dkv_bf16(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                            const void* delta, const void* lengths, void* dk, void* dv, int B, int T_len, int S, int H,
                            int Hkv, int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = dkv_bf16_smem_bytes<D>();
  static bool configured = false;
  cudaError_t err = allow_smem(flash_bwd_dkv_bf16_kernel<D, F32_OUT>, smem, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(S, BK), Hkv, B);
  flash_bwd_dkv_bf16_kernel<D, F32_OUT><<<grid, TC_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(lengths), dk, dv, T_len, S, H, Hkv, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: the inputs' type, 0 = float32, 1 = bfloat16; out_dtype: the
// gradients' type, the same codes (bf16 inputs may write fp32 gradients; fp32
// inputs write fp32). window <= 0 means no window. Each returns the
// cudaError_t of its launch (0 on success).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                            const void* delta, const void* lengths, void* dq, int B, int T_len, int S, int H,
                            int Hkv, int D, int dtype, int out_dtype, int causal, int window, float scale,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DQ_ARGS q, k, v, dout, lse, delta, lengths, dq, B, T_len, S, H, Hkv, causal, window, scale, st
  switch (dtype * 10000 + out_dtype * 1000 + D) {
    case 64: return launch_dq_f32<64>(DQ_ARGS);
    case 80: return launch_dq_f32<80>(DQ_ARGS);
    case 128: return launch_dq_f32<128>(DQ_ARGS);
    case 11064: return launch_dq_bf16<64, false>(DQ_ARGS);
    case 11080: return launch_dq_bf16<80, false>(DQ_ARGS);
    case 11128: return launch_dq_bf16<128, false>(DQ_ARGS);
    case 10064: return launch_dq_bf16<64, true>(DQ_ARGS);
    case 10080: return launch_dq_bf16<80, true>(DQ_ARGS);
    case 10128: return launch_dq_bf16<128, true>(DQ_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DQ_ARGS
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                             const void* delta, const void* lengths, void* dk, void* dv, int B, int T_len, int S,
                             int H, int Hkv, int D, int dtype, int out_dtype, int causal, int window, float scale,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DKV_ARGS q, k, v, dout, lse, delta, lengths, dk, dv, B, T_len, S, H, Hkv, causal, window, scale, st
  switch (dtype * 10000 + out_dtype * 1000 + D) {
    case 64: return launch_dkv_f32<64>(DKV_ARGS);
    case 80: return launch_dkv_f32<80>(DKV_ARGS);
    case 128: return launch_dkv_f32<128>(DKV_ARGS);
    case 11064: return launch_dkv_bf16<64, false>(DKV_ARGS);
    case 11080: return launch_dkv_bf16<80, false>(DKV_ARGS);
    case 11128: return launch_dkv_bf16<128, false>(DKV_ARGS);
    case 10064: return launch_dkv_bf16<64, true>(DKV_ARGS);
    case 10080: return launch_dkv_bf16<80, true>(DKV_ARGS);
    case 10128: return launch_dkv_bf16<128, true>(DKV_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DKV_ARGS
}

// Dynamic shared memory of one block (bytes), for the build report: which 0 = dq, 1 = dk/dv.
extern "C" int flash_bwd_smem_bytes(int which, int D, int dtype) {
  switch (which * 10000 + dtype * 1000 + D) {
    case 64: return (int)dq_smem_bytes<64>();
    case 80: return (int)dq_smem_bytes<80>();
    case 128: return (int)dq_smem_bytes<128>();
    case 1064: return (int)dq_bf16_smem_bytes<64>();
    case 1080: return (int)dq_bf16_smem_bytes<80>();
    case 1128: return (int)dq_bf16_smem_bytes<128>();
    case 10064: return (int)dkv_smem_bytes<64>();
    case 10080: return (int)dkv_smem_bytes<80>();
    case 10128: return (int)dkv_smem_bytes<128>();
    case 11064: return (int)dkv_bf16_smem_bytes<64>();
    case 11080: return (int)dkv_bf16_smem_bytes<80>();
    case 11128: return (int)dkv_bf16_smem_bytes<128>();
    default: return -1;
  }
}
