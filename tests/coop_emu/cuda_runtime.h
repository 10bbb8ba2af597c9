#pragma once
// A CPU emulator of the CUDA features that a cooperative kernel of
// csrc/ (one that includes coop.cuh) uses, for the tests that build such a
// kernel with g++: every thread of a launch is a std::thread; a warp's
// threads meet at a barrier for each warp-synchronous primitive, a block's
// at __syncthreads; the blocks of a grid take turns between grid barriers
// (block 0's phase, then block 1's, ..., then the next phase), so a
// `__shared__` variable (here one static for the whole grid) holds what the
// running block wrote.  A kernel whose shared values must outlive a grid
// barrier is emulated right only where every block writes the same values
// there.  cudaLaunchCooperativeKernel hands its launch to `emu_coop_hook`,
// which the including test source sets for its kernel.
#include <algorithm>
#include <barrier>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) alignas(n)

struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorNotSupported = 801,
  cudaErrorCooperativeLaunchTooLarge = 720, cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaDevAttrCooperativeLaunch = 95, cudaDevAttrMultiProcessorCount = 16
};
struct cudaFuncAttributes { int maxDynamicSharedSizeBytes; };

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

// the co-resident blocks the emulated card reports (emu_set_capacity)
inline int emu_capacity = 1024;

struct EmuWarp { std::barrier<> bar{32}; unsigned long long slot[32]; };
struct EmuBlock { std::barrier<> bar; explicit EmuBlock(int n) : bar(n) {} };
inline thread_local EmuWarp* emu_warp;
inline thread_local EmuBlock* emu_block;
inline thread_local int emu_phase;
inline std::mutex emu_mu;
inline std::condition_variable emu_cv;
inline unsigned emu_turn_block, emu_turn_phase;

inline int emu_lane() { return threadIdx.x & 31; }
template <class V> V emu_exch(V v, int src) {
  unsigned long long u = 0;
  std::memcpy(&u, &v, sizeof(V));
  emu_warp->slot[emu_lane()] = u;
  emu_warp->bar.arrive_and_wait();
  u = emu_warp->slot[src];
  emu_warp->bar.arrive_and_wait();
  V r;
  std::memcpy(&r, &u, sizeof(V));
  return r;
}
template <class V> V __shfl_xor_sync(unsigned, V v, int o) { return emu_exch(v, emu_lane() ^ o); }
template <class V> V __shfl_up_sync(unsigned, V v, int d) {
  const int s = emu_lane() - d;
  return emu_exch(v, s >= 0 ? s : emu_lane());
}
template <class V> V __shfl_down_sync(unsigned, V v, int d) {
  const int s = emu_lane() + d;
  return emu_exch(v, s < 32 ? s : emu_lane());
}
template <class V> V __shfl_sync(unsigned, V v, int src) { return emu_exch(v, src); }
inline unsigned __ballot_sync(unsigned, bool p) {
  emu_warp->slot[emu_lane()] = p;
  emu_warp->bar.arrive_and_wait();
  unsigned b = 0;
  for (int i = 0; i < 32; ++i) b |= (emu_warp->slot[i] ? 1u : 0u) << i;
  emu_warp->bar.arrive_and_wait();
  return b;
}
inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp->bar.arrive_and_wait(); }
inline void __syncthreads() { emu_block->bar.arrive_and_wait(); }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __ffs(unsigned v) { return __builtin_ffs(static_cast<int>(v)); }
inline void __threadfence() {}
template <class T> T __ldg(const T* p) { return *p; }
template <class T> T __ldcg(const T* p) { return *p; }
template <class T> T atomicAdd(T* p, T v) {
  std::lock_guard<std::mutex> l(emu_mu);
  const T o = *p;
  *p = o + v;
  return o;
}
inline unsigned __vimin3_u16x2(unsigned a, unsigned b, unsigned c) {
  unsigned r = 0;
  for (int h = 0; h < 32; h += 16) {
    const unsigned x = (a >> h) & 0xffff, y = (b >> h) & 0xffff, z = (c >> h) & 0xffff;
    r |= std::min(x, std::min(y, z)) << h;
  }
  return r;
}
inline double __ddiv_rn(double a, double b) { return a / b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline long long __double_as_longlong(double d) { long long r; std::memcpy(&r, &d, 8); return r; }
inline double __longlong_as_double(long long v) { double r; std::memcpy(&r, &v, 8); return r; }
using std::max;
using std::min;

// The turn of (block, phase): a block runs a phase when its turn comes.
inline void emu_wait_turn(unsigned b, unsigned phase) {
  std::unique_lock<std::mutex> l(emu_mu);
  emu_cv.wait(l, [&] { return emu_turn_block == b && emu_turn_phase == phase; });
}
inline void emu_pass_turn() {
  {
    std::lock_guard<std::mutex> l(emu_mu);
    if (++emu_turn_block == gridDim.x) {
      emu_turn_block = 0;
      ++emu_turn_phase;
    }
  }
  emu_cv.notify_all();
}
// A grid barrier: the block's threads meet, its turn passes on, and it runs
// again in the next phase.
inline void emu_grid_sync() {
  __syncthreads();
  if (threadIdx.x == 0) emu_pass_turn();
  emu_wait_turn(blockIdx.x, ++emu_phase);
}

// Run body() as every thread of a grid x block launch.
inline void emu_run(dim3 grid, dim3 block, const std::function<void()>& body) {
  blockDim = block;
  gridDim = grid;
  emu_turn_block = emu_turn_phase = 0;
  std::vector<std::unique_ptr<EmuBlock>> blocks;
  std::vector<std::unique_ptr<EmuWarp>> warps;
  for (unsigned b = 0; b < grid.x; ++b) {
    blocks.emplace_back(new EmuBlock(static_cast<int>(block.x)));
    for (unsigned w = 0; w < block.x / 32; ++w) warps.emplace_back(new EmuWarp);
  }
  std::vector<std::thread> th;
  for (unsigned b = 0; b < grid.x; ++b) {
    for (unsigned t = 0; t < block.x; ++t) {
      th.emplace_back([&, b, t] {
        threadIdx = dim3(t);
        blockIdx = dim3(b);
        emu_block = blocks[b].get();
        emu_warp = warps[b * (block.x / 32) + t / 32].get();
        emu_phase = 0;
        emu_wait_turn(b, 0);
        body();
        __syncthreads();
        if (t == 0) emu_pass_turn();
      });
    }
  }
  for (auto& x : th) x.join();
}

inline std::function<void(const void*, dim3, dim3, void**)> emu_coop_hook;

// the device's index is the capacity, so coop.cuh's cache of capacities by
// device sees each setting as its own card
inline cudaError_t cudaGetDevice(int* d) { *d = emu_capacity; return cudaSuccess; }
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int attr, int) {
  *v = attr == cudaDevAttrMultiProcessorCount ? emu_capacity : 1;
  return cudaSuccess;
}
inline cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* fa, const void*) {
  fa->maxDynamicSharedSizeBytes = 48 * 1024;
  return cudaSuccess;
}
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, const void*, int,
                                                                 size_t) {
  *n = 1;
  return cudaSuccess;
}
inline cudaError_t cudaLaunchCooperativeKernel(const void* kernel, dim3 grid, dim3 block,
                                               void** args, size_t, cudaStream_t) {
  if (!emu_coop_hook) return cudaErrorNotSupported;
  emu_coop_hook(kernel, grid, block, args);
  return cudaSuccess;
}
inline cudaError_t cudaLaunchKernel(const void*, dim3, dim3, void**, size_t, cudaStream_t) {
  return cudaErrorNotSupported;
}
