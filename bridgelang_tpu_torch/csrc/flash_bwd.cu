// Flash-attention backward for Hopper (sm_90a), plain C interface: two kernels.
//
// Replaces bridgelang_tpu/ops/flash_attention.py::_bwd_dq_kernel (launched
// from `_dq_pallas`) and ::_bwd_dkv_kernel (launched from `_dkv_pallas`), the
// Pallas TPU kernels behind the custom VJP of `flash_attention`. Same
// function: with q pre-scaled by 1/sqrt(D), P = exp(q.k^T - lse) under the
// forward's mask (causal, per-example `lengths`, optional window, keys at
// least as long as queries), dP = dO.v^T, dS = P * (dP - delta) with
// delta = rowsum(dO * O) computed by the caller, and
//   dq = dS.k * scale        (flash_bwd_dq)
//   dv = P^T.dO, dk = dS^T.q  (flash_bwd_dkv; q already carries the scale).
// GQA: query head h reads KV head h / (H / Hkv). The TPU kernel writes dk/dv
// per query head in f32 and sums the groups outside (_flash_bwd, :456); here
// one block per KV head loops over the heads of its group and accumulates in
// fp32 registers, so there is no f32 [B, H, S, D] scratch and each output is
// written once, in k's type. The group sum runs in another order than the
// TPU's. Key slots at or past `lengths` get exactly zero gradient.
//
// Layouts are the public API's and are read in place: q/dO/dq [B, T, H, D],
// k/v/dk/dv [B, S, Hkv, D], lse/delta f32 [B, H, T], all contiguous.
//
// Design. Both kernels use 64-row tiles, 256 threads, four threads per tile
// row. Each staged tile is fp32 in shared memory with rows padded by 4 floats
// (16-byte reads of neighbouring rows fall in distinct banks); rows past the
// valid length (keys) or past T (queries) are zero-filled, so a non-finite
// dead slot cannot leak through a zero probability.
//   dq:  one block per (64-query tile, head, example). q and dO tiles stay
//        staged; the block loops over 64-key tiles with the forward's bounds
//        (flash_attention.py:129-135). Thread (row, sub) forms P and dS for
//        keys sub, sub+4, ..., writes dS to shared memory, then accumulates
//        its quarter of the row's dq (float4 groups sub, sub+4, ...).
//   dkv: one block per (64-key tile, KV head, example). k and v tiles stay
//        staged; the block loops over the group's query heads and, for each,
//        over 64-query tiles from k0 / 64 (causal) to the window bound
//        (flash_attention.py:170-176). Thread (key, sub) forms P and dS for
//        query rows sub, sub+4, ..., stores them transposed, then accumulates
//        its quarter of the key's dk and dv.
// The products run on the fp32 FMA units.
//
// Bound at the training shape (B=16, T=S=352, H=32, D=128, bf16): the two
// kernels read q, k, v, dO (4 x 46 MB) plus lse and delta, and write dq, dk,
// dv (3 x 46 MB): ~0.32 GB, ~0.10 ms at 3.35 TB/s. Their products are 10 D
// FLOPs per attended (row, key) pair; causal rows over ~300 valid keys give
// ~60k pairs per (example, head), ~40 GFLOP in all: ~0.04 ms at the
// 989 TFLOP/s bf16 peak. So the backward is bound by bytes. What this simple
// design leaves on the table: the products run on the FP32 FMA pipes
// (67 TFLOP/s peak, and
// the shared-memory operand reads limit them further) instead of the tensor
// cores (mma.sync / wgmma); tiles are staged with plain loads instead of
// cp.async/TMA, so loads do not overlap arithmetic; P is recomputed in both
// kernels instead of once (FlashAttention-2's single pass with an atomic dq);
// ~150-170 KB of shared memory allows one block per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per block: four per tile row
constexpr int PAD = 4;   // floats of padding per staged row
constexpr float NEG_INF = -1e30f;  // the TPU kernel's mask value

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ inline void store_out(float* p, float x) { *p = x; }
__device__ inline void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Stage 64 rows of D elements into shared fp32 rows of stride D + PAD.
// Row r comes from src + (row0 + r) * row_stride, times `scale`; rows
// r >= n_valid are zero.
template <typename T, int D>
__device__ inline void stage_tile(float* dst, const T* __restrict__ src, long row_stride, int row0,
                                  int n_valid, float scale) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int VPR = D / V;         // loads per row
  for (int i = threadIdx.x; i < 64 * VPR; i += NT) {
    const int r = i / VPR;
    const int c = (i % VPR) * V;
    float vals[V];
    if (r < n_valid) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + (long)(row0 + r) * row_stride + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if constexpr (sizeof(T) == 2) {
          vals[j] = __bfloat162float(e[j]) * scale;
        } else {
          vals[j] = e[j] * scale;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) vals[j] = 0.f;
    }
    float* d = dst + r * (D + PAD) + c;
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      *reinterpret_cast<float4*>(d + j) = make_float4(vals[j], vals[j + 1], vals[j + 2], vals[j + 3]);
    }
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

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ lengths, T* __restrict__ dq, int T_len, int S, int H, int Hkv,
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
  const T* kb = k + ((long)b * S * Hkv + hk) * D;
  const T* vb = v + ((long)b * S * Hkv + hk) * D;
  const int n_rows = min(BQ, T_len - q0);

  stage_tile<T, D>(sq, q + q_off, q_stride, q0, n_rows, scale);
  stage_tile<T, D>(sdo, dout + q_off, q_stride, q0, n_rows, 1.f);
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
    stage_tile<T, D>(sk, kb, kv_stride, k0, min(BK, len - k0), 1.f);
    stage_tile<T, D>(sv, vb, kv_stride, k0, min(BK, len - k0), 1.f);
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
    T* out = dq + q_off + (long)r_glob * q_stride;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int d = 4 * (4 * g + sub);
#pragma unroll
      for (int c = 0; c < 4; ++c) store_out(out + d + c, acc[4 * g + c] * scale);
    }
  }
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * ((size_t)(BK * 2 + BQ * 2) * (D + PAD) + (size_t)2 * BK * (BQ + 1) + 2 * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ lengths, T* __restrict__ dk, T* __restrict__ dv, int T_len, int S,
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

  stage_tile<T, D>(sk, k + kv_off, kv_stride, k0, min(BK, len - k0), 1.f);
  stage_tile<T, D>(sv, v + kv_off, kv_stride, k0, min(BK, len - k0), 1.f);

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
      stage_tile<T, D>(sq, q + q_off, q_stride, q0, n_rows, scale);
      stage_tile<T, D>(sdo, dout + q_off, q_stride, q0, n_rows, 1.f);
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
        store_out(dk + out + d + e, dk_acc[4 * c + e]);
        store_out(dv + out + d + e, dv_acc[4 * c + e]);
      }
    }
  }
}

template <typename KernelT>
cudaError_t allow_smem(KernelT kernel, size_t smem, bool& configured) {
  if (configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) configured = true;
  return err;
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                      const void* delta, const void* lengths, void* dq, int B, int T_len, int S, int H, int Hkv,
                      int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  static bool configured = false;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, D>, smem, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(T_len, BQ), H, B);
  flash_bwd_dq_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<const int*>(lengths),
      static_cast<T*>(dq), T_len, S, H, Hkv, causal, window, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                       const void* delta, const void* lengths, void* dk, void* dv, int B, int T_len, int S, int H,
                       int Hkv, int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  static bool configured = false;
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<T, D>, smem, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(S, BK), Hkv, B);
  flash_bwd_dkv_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<const int*>(lengths),
      static_cast<T*>(dk), static_cast<T*>(dv), T_len, S, H, Hkv, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0 means no window.
// Each returns the cudaError_t of its launch (0 on success).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                            const void* delta, const void* lengths, void* dq, int B, int T_len, int S, int H,
                            int Hkv, int D, int dtype, int causal, int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_dq<float, 64>(q, k, v, dout, lse, delta, lengths, dq, B, T_len, S, H, Hkv, causal, window, scale, st);
  if (dtype == 0 && D == 128)
    return launch_dq<float, 128>(q, k, v, dout, lse, delta, lengths, dq, B, T_len, S, H, Hkv, causal, window, scale, st);
  if (dtype == 1 && D == 64)
    return launch_dq<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, lengths, dq, B, T_len, S, H, Hkv, causal, window,
                                        scale, st);
  if (dtype == 1 && D == 128)
    return launch_dq<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, lengths, dq, B, T_len, S, H, Hkv, causal, window,
                                         scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                             const void* delta, const void* lengths, void* dk, void* dv, int B, int T_len, int S,
                             int H, int Hkv, int D, int dtype, int causal, int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_dkv<float, 64>(q, k, v, dout, lse, delta, lengths, dk, dv, B, T_len, S, H, Hkv, causal, window,
                                 scale, st);
  if (dtype == 0 && D == 128)
    return launch_dkv<float, 128>(q, k, v, dout, lse, delta, lengths, dk, dv, B, T_len, S, H, Hkv, causal, window,
                                  scale, st);
  if (dtype == 1 && D == 64)
    return launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, lengths, dk, dv, B, T_len, S, H, Hkv, causal,
                                         window, scale, st);
  if (dtype == 1 && D == 128)
    return launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, lengths, dk, dv, B, T_len, S, H, Hkv, causal,
                                          window, scale, st);
  return (int)cudaErrorInvalidValue;
}
