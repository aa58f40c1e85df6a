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
// kernel's replicated STAT_W lane width is dropped.
//
// Layouts are the public API's: q/o [B, T, H, D], k/v [B, S, Hkv, D], all
// contiguous, so no transpose runs before or after the kernel.
//
// Design. One thread block per (64-query tile, head, example): blocks run in
// parallel, so the TPU kernel's sequential grid walk becomes a loop inside
// the block over 64-key tiles from `lower` to `upper`, with the TPU kernel's
// causal, length and window bounds (flash_attention.py:69-77). Each key tile
// is staged into shared memory as fp32; rows past the valid length are
// zero-filled, so a dead cache slot holding non-finite values cannot leak
// into a row through a zero probability. 128 threads: two per query row.
// Thread pair (2r, 2r+1) splits the row's 64 scores by key parity and its
// D accumulators by alternating float4 groups; the pair combines its row max
// and row sum with one shuffle. Shared rows are padded by 4 floats so that
// the pair's and the warp's 16-byte reads fall in distinct banks. The
// products run on the fp32 FMA units.
//
// Bound at the serving shape. At B=1, T=S=304, H=32, D=128 in bf16, q+k+v+o
// move about 4 * 304 * 4096 * 2 B = 10 MB: ~3 us at 3.35 TB/s. The causal
// products are ~0.8 GFLOP: ~0.8 us at the 989 TFLOP/s bf16 tensor-core peak.
// So the work is bound by HBM bytes. What this simple design leaves on the
// table: it does the products on the FP32 FMA pipes (67 TFLOP/s peak, and
// the shared-memory operand reads limit it further) instead of the tensor
// cores (mma.sync / wgmma), so it is compute-bound far above the byte bound;
// it stages tiles with plain loads instead of cp.async/TMA, so loads do not
// overlap the arithmetic; a 64-query tile gives only B * H * ceil(T/64)
// blocks (160 at B=1, T=304), about one wave on 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 128;  // threads per block: two per query row
constexpr int PAD = 4;   // floats of padding per staged row
constexpr float NEG_INF = -1e30f;  // the TPU kernel's mask value

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)(BQ + 2 * BK) * (D + PAD) + (size_t)BQ * (BK + 1));
}

__device__ inline void store_out(float* p, float x) { *p = x; }
__device__ inline void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Stage `BK` rows of D elements into shared fp32 rows of stride D + PAD.
// Row r comes from src + (row0 + r) * row_stride; rows r >= n_valid are zero.
template <typename T, int D>
__device__ inline void stage_tile(float* dst, const T* __restrict__ src, long row_stride, int row0,
                                  int n_valid, float scale) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int VPR = D / V;         // loads per row
  for (int i = threadIdx.x; i < BK * VPR; i += NT) {
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

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ lengths, T* __restrict__ o, float* __restrict__ lse,
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
  const T* qb = q + ((long)b * T_len * H + h) * D;
  const T* kb = k + ((long)b * S * Hkv + hk) * D;
  const T* vb = v + ((long)b * S * Hkv + hk) * D;

  stage_tile<T, D>(sq, qb, q_stride, q0, min(BQ, T_len - q0), scale);

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
    stage_tile<T, D>(sk, kb, kv_stride, k0, min(BK, len - k0), 1.f);
    stage_tile<T, D>(sv, vb, kv_stride, k0, min(BK, len - k0), 1.f);
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
    T* orow = o + ((long)b * T_len * H + (long)r_glob * H + h) * D;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int d = 4 * (2 * g + half);
#pragma unroll
      for (int c = 0; c < 4; ++c) store_out(orow + d + c, acc[4 * g + c] / l_safe);
    }
    if (half == 0) lse[((long)b * H + h) * T_len + r_glob] = m_i + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* lengths, void* o, void* lse,
                   int B, int T_len, int S, int H, int Hkv, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(cdiv(T_len, BQ), H, B);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), static_cast<T*>(o), static_cast<float*>(lse),
      T_len, S, H, Hkv, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0 means no window.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* lengths, void* o,
                         void* lse, int B, int T_len, int S, int H, int Hkv, int D, int dtype, int causal,
                         int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, lengths, o, lse, B, T_len, S, H, Hkv, causal, window, scale, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, lengths, o, lse, B, T_len, S, H, Hkv, causal, window, scale, st);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, lengths, o, lse, B, T_len, S, H, Hkv, causal, window, scale, st);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, lengths, o, lse, B, T_len, S, H, Hkv, causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
