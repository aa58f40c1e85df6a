// A CPU emulation of the CUDA pieces that the port's mma.sync kernels use, so
// that their sources compile with g++ and run on the CPU in tests: one
// std::thread per CUDA thread, blocks one after another; __syncthreads and
// __syncwarp are std::barriers; ldmatrix, mma.sync m16n8k16 (bf16 -> fp32)
// and __shfl_xor_sync are warp collectives that exchange operands through
// the warp's state between two barriers; cp.async copies (or zero-fills) at
// once. Shared memory starts as garbage, as on the card. bf16 rounds to
// nearest even. The sums of an emulated mma run in another order than the
// tensor cores', so results agree with the card to fp32 rounding, not bit
// for bit. Build with -fno-strict-aliasing: the kernels read shared memory
// through reinterpreted pointers.
#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <barrier>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint4 { unsigned x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
using std::max;
using std::min;

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr cudaError_t cudaSuccess = 0, cudaErrorInvalidValue = 1;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

struct WarpState {
  std::barrier<> bar{32};
  uint32_t u[32][6];
  float f[32];
};
inline thread_local dim3 threadIdx, blockIdx, gridDim;
inline thread_local uint8_t* emu_smem;
inline thread_local std::barrier<>* emu_block;
inline thread_local WarpState* emu_warp;

inline void __syncthreads() { emu_block->arrive_and_wait(); }
inline void __syncwarp() { emu_warp->bar.arrive_and_wait(); }
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)((const uint8_t*)p - emu_smem); }
inline int emu_lane() { return threadIdx.x % 32; }

// kernel<<<grid, threads, smem, stream>>>(args) becomes emu_launch(grid, threads, smem, [&] { kernel(args); }).
inline void emu_launch(dim3 grid, int threads, size_t smem, const std::function<void()>& body) {
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        std::vector<uint8_t> shared(smem + 16, 0xCD);
        std::barrier<> block(threads);
        std::vector<std::unique_ptr<WarpState>> warps;
        for (int w = 0; w < (threads + 31) / 32; ++w) warps.emplace_back(new WarpState);
        std::vector<std::thread> pool;
        for (int i = 0; i < threads; ++i)
          pool.emplace_back([&, i] {
            threadIdx = dim3(i), blockIdx = dim3(x, y, z), gridDim = grid;
            emu_smem = shared.data(), emu_block = &block, emu_warp = warps[i / 32].get();
            body();
          });
        for (auto& t : pool) t.join();
      }
}

// bf16
struct __nv_bfloat16 { uint16_t x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline uint16_t emu_f2bf(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0;
  return (uint16_t)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}
inline float emu_bf2f(uint16_t h) {
  const uint32_t u = (uint32_t)h << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) { return {emu_f2bf(f)}; }
inline float __bfloat162float(__nv_bfloat16 h) { return emu_bf2f(h.x); }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) { return {{emu_f2bf(a)}, {emu_f2bf(b)}}; }
inline float2 __bfloat1622float2(__nv_bfloat162 h) { return {emu_bf2f(h.x.x), emu_bf2f(h.y.x)}; }

// What the kernels write as inline PTX.
inline void cp_async16(uint32_t dst, const void* src, bool valid) {
  valid ? (void)memcpy(emu_smem + dst, src, 16) : (void)memset(emu_smem + dst, 0, 16);
}
inline void cp_async4(uint32_t dst, const void* src, bool valid) {
  valid ? (void)memcpy(emu_smem + dst, src, 4) : (void)memset(emu_smem + dst, 0, 4);
}
inline void cp_async_commit() {}
inline void cp_async_wait_all() {}

// ldmatrix .x4: lanes 8m .. 8m + 7 address the rows of matrix m; lane 4g + t
// receives row g, columns 2t and 2t + 1 of each matrix (.trans: rows 2t and
// 2t + 1 of column g).
inline void emu_ldsm_x4(uint32_t r[4], uint32_t addr, bool trans) {
  WarpState* w = emu_warp;
  const int lane = emu_lane(), g = lane >> 2, t = lane & 3;
  w->u[lane][0] = addr;
  w->bar.arrive_and_wait();
  for (int m = 0; m < 4; ++m) {
    if (!trans) {
      memcpy(&r[m], emu_smem + w->u[m * 8 + g][0] + 4 * t, 4);
    } else {
      uint16_t lo, hi;
      memcpy(&lo, emu_smem + w->u[m * 8 + 2 * t][0] + 2 * g, 2);
      memcpy(&hi, emu_smem + w->u[m * 8 + 2 * t + 1][0] + 2 * g, 2);
      r[m] = lo | ((uint32_t)hi << 16);
    }
  }
  w->bar.arrive_and_wait();
}
inline void ldsm_x4(uint32_t r[4], uint32_t addr) { emu_ldsm_x4(r, addr, false); }
inline void ldsm_x4_t(uint32_t r[4], uint32_t addr) { emu_ldsm_x4(r, addr, true); }

// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32: c += A (16 x 16) B (16 x 8).
inline void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  WarpState* w = emu_warp;
  const int lane = emu_lane();
  for (int i = 0; i < 4; ++i) w->u[lane][i] = a[i];
  w->u[lane][4] = b0, w->u[lane][5] = b1;
  w->bar.arrive_and_wait();
  float A[16][16], B[16][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l >> 2, t = l & 3;
    for (int e = 0; e < 2; ++e) {
      auto half = [e](uint32_t x) { return emu_bf2f((uint16_t)(e ? x >> 16 : x & 0xffffu)); };
      A[g][2 * t + e] = half(w->u[l][0]), A[g + 8][2 * t + e] = half(w->u[l][1]);
      A[g][2 * t + 8 + e] = half(w->u[l][2]), A[g + 8][2 * t + 8 + e] = half(w->u[l][3]);
      B[2 * t + e][g] = half(w->u[l][4]), B[2 * t + 8 + e][g] = half(w->u[l][5]);
    }
  }
  w->bar.arrive_and_wait();
  const int g = lane >> 2, t = lane & 3;
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    float s = 0.f;
    for (int k = 0; k < 16; ++k) s += A[row][k] * B[k][col];
    c[e] += s;
  }
}

inline float __shfl_xor_sync(unsigned, float v, int mask) {
  WarpState* w = emu_warp;
  const int lane = emu_lane();
  w->f[lane] = v;
  w->bar.arrive_and_wait();
  const float out = w->f[lane ^ mask];
  w->bar.arrive_and_wait();
  return out;
}
