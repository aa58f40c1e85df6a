// A CPU emulation of the CUDA pieces that the port's tensor-core kernels use,
// so that their sources compile with g++ and run on the CPU in tests: one
// fiber (a ucontext with its own stack) per CUDA thread, all of a block's on
// the calling thread, blocks one after another. A fiber runs until it waits
// at a barrier (__syncthreads, __syncwarp and the warp and warpgroup
// collectives' exchanges) or ends; the next runnable fiber in thread order
// then runs, and the last to arrive at a barrier releases its waiters and
// goes on. So a block runs one valid interleaving of its threads, the same
// one every time, and no OS scheduling is involved (a kernel that deadlocks
// aborts). ldmatrix, mma.sync (m16n8k16 bf16 -> fp32,
// m16n8k32 s8 -> s32) and __shfl_xor_sync are warp collectives, and wgmma
// (A in registers, B through a K-major 128-byte-swizzled shared-memory
// descriptor: the one layout the kernels build) a warpgroup collective, each
// exchanging operands through shared state between two barriers; cp.async
// copies (or zero-fills) at once and wgmma completes at once, so the fences,
// commits and waits are no-ops. Static __shared__ arrays are function
// statics: one per kernel, shared by the block's threads (blocks run one
// after another). Dynamic shared memory starts as garbage, as on the card.
// bf16 rounds to nearest even. The float sums of an emulated mma run in
// another order than the tensor cores', so bf16 results agree with the card
// to fp32 rounding, not bit for bit; the int8 ones are exact. Build with
// -fno-strict-aliasing: the kernels read shared memory through
// reinterpreted pointers.
#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <stdio.h>
#include <stdlib.h>
#include <ucontext.h>

#include <algorithm>
#include <atomic>
#include <functional>
#include <memory>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n)
#define __shared__ static

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint4 { unsigned x, y, z, w; };
struct uint2 { unsigned x, y; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float2 make_float2(float a, float b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
using std::max;
using std::min;

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr cudaError_t cudaSuccess = 0, cudaErrorInvalidValue = 1;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
// Resident blocks per SM: a fixed 4 here (the card's depends on the compiled kernel).
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 4;
  return cudaSuccess;
}
enum cudaStreamCaptureStatus { cudaStreamCaptureStatusNone, cudaStreamCaptureStatusActive };
inline cudaError_t cudaStreamGetCaptureInfo(cudaStream_t, cudaStreamCaptureStatus* status, unsigned long long* id) {
  *status = cudaStreamCaptureStatusNone;  // the emulation runs no graphs
  *id = 0;
  return cudaSuccess;
}

// The fibers of the running block (emu_launch), the one running, and its entry.
struct EmuFiber {
  ucontext_t ctx;
  bool waiting = false, done = false;
};
struct EmuScheduler {
  ucontext_t main;
  std::vector<EmuFiber> fibers;
  int current = 0;
  const std::function<void()>* body = nullptr;
};
inline thread_local EmuScheduler* emu_sched;

inline void emu_fiber_entry() {
  EmuScheduler* s = emu_sched;
  (*s->body)();
  s->fibers[s->current].done = true;  // uc_link returns to the scheduler
}

// A barrier of `n` fibers: each but the last parks and yields to the
// scheduler; the last makes the parked ones runnable again and goes on.
struct EmuBarrier {
  int n, arrived = 0;
  std::vector<int> parked;
  explicit EmuBarrier(int count) : n(count) {}
  void arrive_and_wait() {
    EmuScheduler* s = emu_sched;
    if (++arrived == n) {
      arrived = 0;
      for (int f : parked) s->fibers[f].waiting = false;
      parked.clear();
      return;
    }
    const int me = s->current;
    s->fibers[me].waiting = true;
    parked.push_back(me);
    swapcontext(&s->fibers[me].ctx, &s->main);
  }
};

struct WarpState {
  EmuBarrier bar{32};
  uint32_t u[32][6];
  float f[32];
  int i[32];
};
struct WarpgroupState {
  EmuBarrier bar{128};
  uint32_t a[128][4];
};
inline thread_local dim3 threadIdx, blockIdx, gridDim;
inline thread_local uint8_t* emu_smem;
inline thread_local EmuBarrier* emu_block;
inline thread_local WarpState* emu_warp;
inline thread_local WarpgroupState* emu_wg;

inline void __syncthreads() { emu_block->arrive_and_wait(); }
inline void __syncwarp() { emu_warp->bar.arrive_and_wait(); }
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)((const uint8_t*)p - emu_smem); }
inline int emu_lane() { return threadIdx.x % 32; }

// kernel<<<grid, threads, smem, stream>>>(args) becomes emu_launch(grid, threads, smem, [&] { kernel(args); }).
inline void emu_launch(dim3 grid, int threads, size_t smem, const std::function<void()>& body) {
  constexpr size_t STACK = 256 * 1024;  // per fiber; pages are touched only as used
  std::unique_ptr<char[]> stacks(new char[STACK * threads]);
  EmuScheduler sched;
  sched.body = &body;
  EmuScheduler* outer = emu_sched;
  emu_sched = &sched;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        std::vector<uint8_t> shared(smem + 16, 0xCD);
        EmuBarrier block(threads);
        std::vector<std::unique_ptr<WarpState>> warps;
        for (int w = 0; w < (threads + 31) / 32; ++w) warps.emplace_back(new WarpState);
        std::vector<std::unique_ptr<WarpgroupState>> groups;
        for (int w = 0; w < threads / 128; ++w) groups.emplace_back(new WarpgroupState);
        sched.fibers.assign(threads, EmuFiber());
        for (int i = 0; i < threads; ++i) {
          ucontext_t& c = sched.fibers[i].ctx;
          getcontext(&c);
          c.uc_stack.ss_sp = stacks.get() + STACK * i;
          c.uc_stack.ss_size = STACK;
          c.uc_link = &sched.main;
          makecontext(&c, emu_fiber_entry, 0);
        }
        for (int alive = threads; alive > 0;) {
          bool ran = false;
          for (int i = 0; i < threads; ++i) {
            EmuFiber& f = sched.fibers[i];
            if (f.done || f.waiting) continue;
            threadIdx = dim3(i), blockIdx = dim3(x, y, z), gridDim = grid;
            emu_smem = shared.data(), emu_block = &block, emu_warp = warps[i / 32].get();
            emu_wg = i / 128 < (int)groups.size() ? groups[i / 128].get() : nullptr;
            sched.current = i;
            swapcontext(&sched.main, &f.ctx);
            ran = true;
            alive -= f.done;
          }
          if (!ran) {
            fprintf(stderr, "cuda_emu: every live thread of block (%u, %u, %u) waits at a barrier\n", x, y, z);
            abort();
          }
        }
      }
  emu_sched = outer;
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
inline __nv_bfloat16 __float2bfloat16_rn(float f) { return {emu_f2bf(f)}; }
inline __nv_bfloat162 __hsub2(__nv_bfloat162 a, __nv_bfloat162 b) {
  return {{emu_f2bf(emu_bf2f(a.x.x) - emu_bf2f(b.x.x))}, {emu_f2bf(emu_bf2f(a.y.x) - emu_bf2f(b.y.x))}};
}

// Integer and rounding intrinsics, memory order.
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t b = x | ((uint64_t)y << 32);
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i) r |= (uint32_t)((b >> (8 * ((s >> (4 * i)) & 7))) & 0xff) << (8 * i);
  return r;
}
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __ldcg(const float* p) { return *p; }
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline float __uint_as_float(uint32_t u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  return u;
}
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
template <int N>
inline void cp_async_wait() {}

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

inline int __shfl_xor_sync(unsigned, int v, int mask) {
  WarpState* w = emu_warp;
  const int lane = emu_lane();
  w->i[lane] = v;
  w->bar.arrive_and_wait();
  const int out = w->i[lane ^ mask];
  w->bar.arrive_and_wait();
  return out;
}

// mma.sync.m16n8k32.row.col.s32.s8.s8.s32: c += A (16 x 32) B (32 x 8), exact.
inline void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  WarpState* w = emu_warp;
  const int lane = emu_lane();
  for (int i = 0; i < 4; ++i) w->u[lane][i] = a[i];
  w->u[lane][4] = b0, w->u[lane][5] = b1;
  w->bar.arrive_and_wait();
  int A[16][32], B[32][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l >> 2, t = l & 3;
    for (int e = 0; e < 4; ++e) {
      auto byte = [e](uint32_t x) { return (int)(int8_t)(x >> (8 * e)); };
      A[g][4 * t + e] = byte(w->u[l][0]), A[g + 8][4 * t + e] = byte(w->u[l][1]);
      A[g][16 + 4 * t + e] = byte(w->u[l][2]), A[g + 8][16 + 4 * t + e] = byte(w->u[l][3]);
      B[4 * t + e][g] = byte(w->u[l][4]), B[16 + 4 * t + e][g] = byte(w->u[l][5]);
    }
  }
  w->bar.arrive_and_wait();
  const int g = lane >> 2, t = lane & 3;
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    int s = 0;
    for (int k = 0; k < 32; ++k) s += A[row][k] * B[k][col];
    c[e] += s;
  }
}

// wgmma: completes at once, so its fences, commits and waits do nothing.
inline void fence_proxy_async() {}
inline void wgmma_fence() {}
inline void wgmma_commit() {}
template <int N>
inline void wgmma_wait() {}
template <class T, int N>
inline void fence_regs(T (&)[N]) {}

// wgmma.mma_async m64nNkK, D (+)= A (64 x K, registers) x B (K x N, shared).
// A: warp w of the warpgroup holds rows 16w .. 16w + 15 in the mma.sync A
// layout of element type E (4 / sizeof(E) elements per register). B: the
// descriptor's K-major tile, rows (the N index) of 128 bytes in 8-row groups
// `stride` bytes apart, swizzled by address bits [4, 7) ^= [7, 10) (the
// 128-byte swizzle of a 1024-aligned tile). D: rows 16w + g (+ 8), columns
// 8j + 2t (+ 1) in d[4j + e], as mma.sync's C.
template <class E, int N, int K, class Acc, class ToAcc>
inline void emu_wgmma(Acc* d, const uint32_t a[4], uint64_t desc, int scale_d, ToAcc to_acc) {
  WarpgroupState* wg = emu_wg;
  const int tid = threadIdx.x % 128;
  for (int i = 0; i < 4; ++i) wg->a[tid][i] = a[i];
  wg->bar.arrive_and_wait();
  constexpr int PER = 4 / sizeof(E);
  const uint32_t start = (uint32_t)(desc & 0x3FFF) << 4, stride = (uint32_t)((desc >> 32) & 0x3FFF) << 4;
  const int warp = tid / 32, g = (tid % 32) >> 2, t = tid & 3;
  for (int i = 0; i < N / 2; ++i) {
    const int j = i / 4, e = i % 4;
    const int row = 16 * warp + g + 8 * (e >> 1), col = 8 * j + 2 * t + (e & 1);
    Acc s = 0;
    for (int k = 0; k < K; ++k) {
      const int half = k / (K / 2), kk = k % (K / 2);
      const int src = 32 * warp + 4 * ((row % 16) % 8) + kk / PER;
      E av, bv;
      const uint32_t reg = wg->a[src][2 * half + (row % 16) / 8];
      memcpy(&av, reinterpret_cast<const uint8_t*>(&reg) + sizeof(E) * (kk % PER), sizeof(E));
      const uint32_t lin = start + (col / 8) * stride + (col % 8) * 128 + k * sizeof(E);
      memcpy(&bv, emu_smem + (lin ^ (((lin >> 7) & 7) << 4)), sizeof(E));
      s += to_acc(av) * to_acc(bv);
    }
    d[i] = scale_d ? d[i] + s : s;
  }
  wg->bar.arrive_and_wait();
}
inline void wgmma_m64n128k16(float d[64], const uint32_t a[4], uint64_t desc, int scale_d) {
  emu_wgmma<__nv_bfloat16, 128, 16, float>(d, a, desc, scale_d, [](__nv_bfloat16 v) { return emu_bf2f(v.x); });
}
inline void wgmma_m64n64k32_s8(int d[32], const uint32_t a[4], uint64_t desc, int scale_d) {
  emu_wgmma<int8_t, 64, 32, int>(d, a, desc, scale_d, [](int8_t v) { return (int)v; });
}
