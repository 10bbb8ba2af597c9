#pragma once
// A CPU emulator of the CUDA features csrc/kmer_count.cu uses, for
// tests/test_torch_device_histograms.py: a warp is 32 std::threads that meet
// at a barrier for every warp-synchronous primitive (shuffles, ballot,
// __syncwarp); the warps of a launch run one after another, each block's
// shared memory filled with garbage first; atomics take one mutex.  The
// test rewrites each `kernel<<<grid, block, shm, stream>>>(a)` into
// emu_launch(kernel, grid, block, shm, a).
#include <cstdint>
#include <cstddef>
#include <cstring>
#include <algorithm>
#include <barrier>
#include <mutex>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
typedef int cudaError_t; typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 2 };
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
struct WarpCtx { std::barrier<> bar{32}; unsigned long long slot[32]; };
inline thread_local WarpCtx* g_warp;
inline thread_local unsigned* g_smem;
inline std::mutex g_atomic;
inline unsigned* emu_smem() { return g_smem; }
inline int lane_id() { return threadIdx.x & 31; }
template <class V> V exch(V v, int src) {
  g_warp->slot[lane_id()] = (unsigned long long)v; g_warp->bar.arrive_and_wait();
  V r = (V)g_warp->slot[src]; g_warp->bar.arrive_and_wait(); return r; }
inline unsigned __shfl_down_sync(unsigned, unsigned v, int d) { int s = lane_id() + d; return exch(v, s < 32 ? s : lane_id()); }
inline unsigned __shfl_xor_sync(unsigned, unsigned v, int o) { return exch(v, lane_id() ^ o); }
inline int __shfl_sync(unsigned, int v, int src) { return exch(v, src); }
inline unsigned __ballot_sync(unsigned, bool p) {
  g_warp->slot[lane_id()] = p; g_warp->bar.arrive_and_wait();
  unsigned b = 0; for (int i = 0; i < 32; ++i) if (g_warp->slot[i]) b |= 1u << i;
  g_warp->bar.arrive_and_wait(); return b; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline void __syncwarp(unsigned = 0xffffffffu) { g_warp->bar.arrive_and_wait(); }
inline void __threadfence() {}
template <class T> T __ldg(const T* p) { return *p; }
template <class T> T __ldcg(const T* p) { std::lock_guard<std::mutex> l(g_atomic); return *p; }
template <class T> void __stcg(T* p, T v) { std::lock_guard<std::mutex> l(g_atomic); *p = v; }
template <class T> T atomicAdd(T* p, T v) { std::lock_guard<std::mutex> l(g_atomic); T o = *p; *p = o + v; return o; }
inline unsigned atomicCAS(unsigned* p, unsigned c, unsigned v) { std::lock_guard<std::mutex> l(g_atomic); unsigned o = *p; if (o == c) *p = v; return o; }
using std::min; using std::max;
template <class K, class A>
void emu_launch(K kernel, dim3 grid, dim3 block, size_t shm, const A& a) {
  blockDim = block; gridDim = grid;
  std::vector<unsigned> smem(shm / 4 + 4);
  for (unsigned b = 0; b < grid.x; ++b) {
    std::fill(smem.begin(), smem.end(), 0xdeadbeefu);   // uninitialised
    for (unsigned w = 0; w < block.x / 32; ++w) {
      WarpCtx ctx;
      std::vector<std::thread> th;
      for (unsigned l = 0; l < 32; ++l)
        th.emplace_back([&, l] { threadIdx = dim3(32 * w + l); blockIdx = dim3(b); g_warp = &ctx; g_smem = smem.data(); kernel(a); });
      for (auto& t : th) t.join();
    }
  }
}
