// Device and launch helpers shared by closest_mean.cu (the segmented
// closest-to-mean), window_absorb.cu (the accumulate step's tail) and
// phase.cu (the update phase's layout and replay).
//
// The step kernel runs as one cooperative launch (cudaLaunchCooperativeKernel)
// whose phases are separated by grid-wide barriers (cooperative_groups::
// this_grid().sync(), which needs no -rdc since CUDA 11).  A cooperative
// grid must be co-resident on the card, so coop_launch sizes it to min(the
// blocks the work wants, the blocks that fit at once by the occupancy
// calculator, kMaxGrid); the kernel loops over its tiles, so the result
// does not depend on the grid size.  A refused launch returns its error to
// the wrapper, which raises: there is no fallback.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace mc2 {

namespace cg = cooperative_groups;

constexpr int kWarpSize = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarpSize;
constexpr unsigned kFullMask = 0xffffffffu;
// the largest grid: the kernels keep per-block partials in kMaxGrid slots
constexpr int kMaxGrid = 1024;

__device__ __forceinline__ long long warp_sum(long long x) {
#pragma unroll
  for (int o = kWarpSize / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

// Sum over the block; every thread gets the total.  buf holds kWarps values.
__device__ __forceinline__ long long block_sum(long long x, long long* buf) {
  x = warp_sum(x);
  __syncthreads();  // buf may still be read from a previous call
  if ((threadIdx.x & (kWarpSize - 1)) == 0) buf[threadIdx.x / kWarpSize] = x;
  __syncthreads();
  long long t = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += buf[w];
  return t;
}

// (v, p) comes before (w, q): for MAX a larger v, else a smaller v, or the
// same v at an earlier position.  For MAX an empty slot (p < 0) comes last.
template <bool MAX>
__device__ __forceinline__ bool before(double v, long long p, double w, long long q) {
  if (MAX) {
    if (p < 0) return false;
    if (q < 0) return true;
    return v > w || (v == w && p < q);
  }
  return v < w || (v == w && p < q);
}

// The first maximum (MAX) or first minimum of (v, p) over the block; every
// thread gets it.  sv, sp hold kWarps values.
template <bool MAX>
__device__ __forceinline__ void block_first(double& v, long long& p, double* sv,
                                            long long* sp) {
#pragma unroll
  for (int o = kWarpSize / 2; o > 0; o >>= 1) {
    const double ov = __shfl_xor_sync(kFullMask, v, o);
    const long long op = __shfl_xor_sync(kFullMask, p, o);
    if (before<MAX>(ov, op, v, p)) {
      v = ov;
      p = op;
    }
  }
  __syncthreads();  // sv, sp may still be read from a previous call
  if ((threadIdx.x & (kWarpSize - 1)) == 0) {
    sv[threadIdx.x / kWarpSize] = v;
    sp[threadIdx.x / kWarpSize] = p;
  }
  __syncthreads();
  v = sv[0];
  p = sp[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    if (before<MAX>(sv[w], sp[w], v, p)) {
      v = sv[w];
      p = sp[w];
    }
  }
}

// sum_e min(x_e, y_e) over the bins packed in one 32-bit word, as two
// 16-bit lanes (each <= 510 for uint8, <= 65535 for uint16), with Hopper's
// DPX per-halfword minimum (__vimin3_u16x2 against all ones): uint8 bins
// are split into their even and odd bytes first.
template <typename T>
__device__ __forceinline__ unsigned min_pair16(unsigned x, unsigned y) {
  constexpr unsigned kOnes = 0xffffffffu;
  if (sizeof(T) == 1) {
    constexpr unsigned kEven = 0x00ff00ffu;
    return __vimin3_u16x2(x & kEven, y & kEven, kOnes) +
           __vimin3_u16x2((x >> 8) & kEven, (y >> 8) & kEven, kOnes);
  }
  return __vimin3_u16x2(x, y, kOnes);
}

// This lane's share of sum_e min(h_e, r_e) over one row (LANES lanes split
// the row, `lane` is this one's index among them; the caller reduces).
// VEC: both rows start on 16-byte boundaries and d sizeof(T) is a multiple
// of 16; four 16-byte chunks of each row are loaded at once.  r may have
// been written earlier in the same launch, so it is read through the
// coherent path.
template <typename T, bool VEC, int LANES = kWarpSize>
__device__ __forceinline__ long long row_min_sum(const T* __restrict__ h, const T* r,
                                                 int d, int lane) {
  long long acc = 0;
  if (VEC) {
    const uint4* h4 = reinterpret_cast<const uint4*>(h);
    const uint4* r4 = reinterpret_cast<const uint4*>(r);
    const int chunks = d * static_cast<int>(sizeof(T)) / 16;
    for (int ch = lane; ch < chunks; ch += 4 * LANES) {
      uint4 x[4], y[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int cu = ch + u * LANES;
        x[u] = cu < chunks ? __ldg(h4 + cu) : make_uint4(0, 0, 0, 0);
        y[u] = cu < chunks ? r4[cu] : make_uint4(0, 0, 0, 0);
      }
      if (sizeof(T) == 1) {
        unsigned p = 0;  // 16 words of <= 510 a lane: fits 16 bits
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          p += min_pair16<T>(x[u].x, y[u].x) + min_pair16<T>(x[u].y, y[u].y) +
               min_pair16<T>(x[u].z, y[u].z) + min_pair16<T>(x[u].w, y[u].w);
        }
        acc += (p & 0xffffu) + (p >> 16);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const unsigned w[4] = {min_pair16<T>(x[u].x, y[u].x), min_pair16<T>(x[u].y, y[u].y),
                                 min_pair16<T>(x[u].z, y[u].z), min_pair16<T>(x[u].w, y[u].w)};
#pragma unroll
          for (int k = 0; k < 4; ++k) acc += (w[k] & 0xffffu) + (w[k] >> 16);
        }
      }
    }
  } else {
    for (int e = lane; e < d; e += LANES) {
      acc += min(static_cast<unsigned>(h[e]), static_cast<unsigned>(r[e]));
    }
  }
  return acc;
}

// Add the bins of row word x to a thread's column sums: acc[j] for the
// 4 / sizeof(T) bins of the word.  uint8 bins go as two 16-bit lanes
// (even, odd bytes) into acc16[0..1], which hold <= 257 rows; fold16
// moves them into acc.
template <typename T>
__device__ __forceinline__ void add_word(unsigned x, unsigned* acc, unsigned* acc16) {
  if (sizeof(T) == 1) {
    acc16[0] += x & 0x00ff00ffu;
    acc16[1] += (x >> 8) & 0x00ff00ffu;
  } else {
    acc[0] += x & 0xffffu;
    acc[1] += x >> 16;
  }
}

template <typename T>
__device__ __forceinline__ void fold16(unsigned* acc, unsigned* acc16) {
  if (sizeof(T) == 1) {
    acc[0] += acc16[0] & 0xffffu;
    acc[1] += acc16[1] & 0xffffu;
    acc[2] += acc16[0] >> 16;
    acc[3] += acc16[1] >> 16;
    acc16[0] = acc16[1] = 0;
  }
}

// engine.distance_d's v = 10000 (1 - (dist2 / mag)^2), with explicitly
// rounded float64 operations, so nvcc's -fmad=true cannot contract
// 1 - frac^2 into an FMA and the host's value comes out bit for bit.
__device__ __forceinline__ double distance_v(long long dist2, long long mag) {
  const double frac = __ddiv_rn(static_cast<double>(dist2), static_cast<double>(mag));
  return __dmul_rn(10000.0, __dsub_rn(1.0, __dmul_rn(frac, frac)));
}

// floor(num / den) for 0 <= num < 2^51 and den >= 1, given inv = 1.0 / den:
// inv and the product are each rounded once, so the product lies within
// num / den * 2^-52 (< 0.5) of the quotient, and one integer step makes it
// exact (a 64-bit integer division costs ~70 instructions).  The column
// sums it divides are at most rows x maxc, far below 2^51 inside the
// store's envelope (rows < 2^31, counts < 2^16).
__device__ __forceinline__ long long floor_div(long long num, long long den, double inv) {
  long long q = static_cast<long long>(static_cast<double>(num) * inv);
  if (q * den > num) {
    --q;
  } else if ((q + 1) * den <= num) {
    ++q;
  }
  return q;
}

// One bin of a mean over den rows with column sum num (inv = 1.0 / den):
// q = floor(num / den) (summed into sfloor), r = the round-half-up mean,
// and whether the host's float64 mean could round or truncate differently
// there (g1-g3, device_update.py:314-331).  For integer rem and real t,
// rem <= t iff rem <= floor(t), so comparing against the floored shifts is
// exact.
struct BinMean {
  long long q;
  long long r;
  bool guard;
};

__device__ __forceinline__ BinMean bin_mean(long long num, long long den, double inv,
                                            long long maxc) {
  const long long q = floor_div(num, den, inv);
  const long long rem = num - q * den;
  const long long half = 2 * rem - den;
  const long long half_abs = half < 0 ? -half : half;
  const bool g1 = half_abs != 0 && half_abs <= (((q + 2) * den) >> 51);
  const bool g2 = rem != 0 && rem <= (((q + 2) * den) >> 52);
  const bool g3 = rem != 0 && (den - rem) <= (((q + maxc + 2) * den) >> 52);
  // floor((2 num + den) / (2 den)) = q + (2 rem >= den)
  return {q, q + (2 * rem >= den ? 1 : 0), g1 || g2 || g3};
}

// The most blocks of `kernel` (`threads` threads, shm dynamic bytes) that
// are co-resident on the current card, capped at kMaxGrid; cached per
// (kernel, shm, threads, device).
inline cudaError_t coop_capacity(const void* kernel, size_t shm, int* cap,
                                 int threads = kThreads) {
  struct Entry {
    const void* kernel;
    size_t shm;
    int threads;
    int dev;
    int cap;
  };
  static Entry cache[64];
  static int n_cached = 0;
  static std::mutex mu;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_cached; ++i) {
    if (cache[i].kernel == kernel && cache[i].shm == shm && cache[i].threads == threads &&
        cache[i].dev == dev) {
      *cap = cache[i].cap;
      return cudaSuccess;
    }
  }
  int coop = 0, sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  // the kernel's dynamic shared memory may start below 48 KB less its
  // static shared memory; raised only, so a size cached earlier stays allowed
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return e;
  if (static_cast<size_t>(fa.maxDynamicSharedSizeBytes) < shm) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(shm));
    if (e != cudaSuccess) return e;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, shm);
  if (e != cudaSuccess) return e;
  const long long c = static_cast<long long>(sms) * per_sm;
  if (c < 1) return cudaErrorCooperativeLaunchTooLarge;
  *cap = static_cast<int>(c < kMaxGrid ? c : kMaxGrid);
  if (n_cached < 64) cache[n_cached++] = {kernel, shm, threads, dev, *cap};
  return cudaSuccess;
}

// Launch `kernel` plainly on `stream`: min(max(want, 1), kMaxGrid) blocks of
// kThreads threads, shm bytes of dynamic shared memory (its limit raised
// above 32 KB, beside the kernels' few KB of static shared memory).  For
// kernels whose blocks never wait for each other.
inline cudaError_t plain_launch(const void* kernel, long long want, size_t shm, void** args,
                                cudaStream_t stream) {
  if (shm > 32 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shm));
    if (e != cudaSuccess) return e;
  }
  const long long g = want < 1 ? 1 : (want < kMaxGrid ? want : kMaxGrid);
  return cudaLaunchKernel(kernel, dim3(static_cast<unsigned>(g)), dim3(kThreads), args, shm,
                          stream);
}

// Launch `kernel` cooperatively on `stream`: min(want, capacity) blocks of
// `threads` threads, shm bytes of dynamic shared memory.
inline cudaError_t coop_launch(const void* kernel, long long want, size_t shm,
                               void** args, cudaStream_t stream, int threads = kThreads) {
  int cap = 0;
  const cudaError_t e = coop_capacity(kernel, shm, &cap, threads);
  if (e != cudaSuccess) return e;
  const long long g = want < 1 ? 1 : (want < cap ? want : cap);
  return cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(g)),
                                     dim3(threads), args, shm, stream);
}

}  // namespace mc2
