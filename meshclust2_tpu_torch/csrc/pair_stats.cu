// Pair statistics over a device-resident k-mer histogram store.
//
// For each pair p, with h = counts[a_idx[p]] and c = counts[b_idx[p]]:
//   out[p][0] = sum_i min(h_i, c_i)
//   out[p][1] = sum_i h_i * c_i
//   out[p][2] = sum_j |sum_{i<=j} (h_i - c_i)|        (EMD)
// as exact int64.  These three integers, plus per-row moments, are all the
// default feature preset needs (ops/pair_stats.py:derive_singles).
//
// Replaces meshclust2_tpu/ops/pallas_stats.py:_build.kernel, the TPU kernel
// that streams a [tile_b, D] block of candidate rows against ONE center row
// and forms the EMD prefix with 128x128 triangular MXU matmuls and a carry.
// This kernel computes the same three statistics but serves both entry
// shapes with one gather: block-vs-one-center (b_idx constant) and
// row-vs-row (the update phase's filter and merge batches).
//
// What bounds it on an H100: bytes of HBM.  Each pair reads two rows of D
// narrow counts (2 KiB at D = 1024, uint8) and does ~10 integer operations
// per element, far below the card's integer rate, so the kernel is
// read-bound.  The design keeps the rows narrow all the way into registers:
//   - one warp per pair; lane l owns the contiguous slice
//     [l * D/32, (l + 1) * D/32) of both rows and loads it as 16-byte vectors
//     where the slice allows, widening to int only in registers;
//   - pass 1 forms the lane's sum-min, dot and the total of its diffs;
//   - a __shfl_up_sync warp scan of those totals gives each lane the prefix
//     that precedes its slice;
//   - pass 2 re-reads the slice (an L1/L2 hit, not HBM) and sums
//     |offset + local prefix|;
//   - __shfl_xor_sync reductions, and lane 0 writes the three int64s.
// The center form re-reads one center row per pair, which stays in L1/L2;
// only the candidate rows cost HBM.
//
// Exactness: sum-min and dot are summed in 64 bits (each u16 x u16 product
// fits 32 unsigned bits), the running prefix and the EMD in 64 bits, so the
// result is exact for any D and either width.  Inside the device envelope
// (cluster/device_loop.py:envelope_check) sum-min and dot are < 2^31, but
// D * max magnitude can exceed 2^31, so the EMD needs the 64-bit total.
//
// An index outside [0, n_rows) writes -1 into all three outputs of its pair
// (every real statistic is >= 0); callers validate indices before launch.
//
// Built by nvcc for sm_90a (ops/_build.py) and bound through ctypes: each
// entry point launches on the given stream, allocates nothing, does not
// synchronise and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpSize = 32;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

// 16 bytes of T, for vector loads of the lane's slice.
template <typename T>
union Vec16 {
  uint4 raw;
  T e[16 / sizeof(T)];
};

struct LaneStats {
  long long smin;
  unsigned long long dot;
  long long diff_total;
};

// Pass 1 over the lane's slice [0, n) of h and c.
template <typename T, bool VEC>
__device__ __forceinline__ LaneStats lane_pass1(const T* __restrict__ h,
                                                const T* __restrict__ c,
                                                int n) {
  LaneStats s{0, 0ull, 0};
  if (VEC) {
    constexpr int E = 16 / sizeof(T);
    for (int off = 0; off < n; off += E) {
      Vec16<T> hv, cv;
      hv.raw = *reinterpret_cast<const uint4*>(h + off);
      cv.raw = *reinterpret_cast<const uint4*>(c + off);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const unsigned x = hv.e[e];
        const unsigned y = cv.e[e];
        s.smin += min(x, y);
        s.dot += static_cast<unsigned long long>(x * y);
        s.diff_total += static_cast<long long>(x) - static_cast<long long>(y);
      }
    }
  } else {
    for (int i = 0; i < n; ++i) {
      const unsigned x = h[i];
      const unsigned y = c[i];
      s.smin += min(x, y);
      s.dot += static_cast<unsigned long long>(x * y);
      s.diff_total += static_cast<long long>(x) - static_cast<long long>(y);
    }
  }
  return s;
}

// Pass 2: sum_j |offset + sum_{i<=j} (h_i - c_i)| over the lane's slice.
template <typename T, bool VEC>
__device__ __forceinline__ unsigned long long lane_pass2(
    const T* __restrict__ h, const T* __restrict__ c, int n, long long run) {
  unsigned long long emd = 0ull;
  if (VEC) {
    constexpr int E = 16 / sizeof(T);
    for (int off = 0; off < n; off += E) {
      Vec16<T> hv, cv;
      hv.raw = *reinterpret_cast<const uint4*>(h + off);
      cv.raw = *reinterpret_cast<const uint4*>(c + off);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        run += static_cast<long long>(hv.e[e]) - static_cast<long long>(cv.e[e]);
        emd += static_cast<unsigned long long>(run < 0 ? -run : run);
      }
    }
  } else {
    for (int i = 0; i < n; ++i) {
      run += static_cast<long long>(h[i]) - static_cast<long long>(c[i]);
      emd += static_cast<unsigned long long>(run < 0 ? -run : run);
    }
  }
  return emd;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kWarpSize * kWarpsPerBlock)
pair_stats_kernel(const T* __restrict__ counts, long long n_rows, int d,
                  const long long* __restrict__ a_idx,
                  const long long* __restrict__ b_idx, long long n_pairs,
                  long long* __restrict__ out) {
  const int lane = threadIdx.x % kWarpSize;
  const long long p =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarpSize;
  if (p >= n_pairs) return;  // uniform across the warp
  const long long a = a_idx[p];
  const long long b = b_idx[p];
  if (a < 0 || a >= n_rows || b < 0 || b >= n_rows) {
    if (lane == 0) {
      out[3 * p + 0] = -1;
      out[3 * p + 1] = -1;
      out[3 * p + 2] = -1;
    }
    return;
  }
  // lane slice: ceil(d / 32) elements from lane * per, clipped to d
  const int per = (d + kWarpSize - 1) / kWarpSize;
  const int start = lane * per;
  const int n = max(0, min(per, d - start));
  const T* h = counts + a * d + start;
  const T* c = counts + b * d + start;

  LaneStats s = lane_pass1<T, VEC>(h, c, n);

  // inclusive warp scan of the lane diff totals -> exclusive offset
  long long incl = s.diff_total;
#pragma unroll
  for (int delta = 1; delta < kWarpSize; delta <<= 1) {
    const long long up = __shfl_up_sync(kFullMask, incl, delta);
    if (lane >= delta) incl += up;
  }
  unsigned long long emd = lane_pass2<T, VEC>(h, c, n, incl - s.diff_total);

  long long smin = s.smin;
  unsigned long long dot = s.dot;
#pragma unroll
  for (int delta = kWarpSize / 2; delta > 0; delta >>= 1) {
    smin += __shfl_xor_sync(kFullMask, smin, delta);
    dot += __shfl_xor_sync(kFullMask, dot, delta);
    emd += __shfl_xor_sync(kFullMask, emd, delta);
  }
  if (lane == 0) {
    out[3 * p + 0] = smin;
    out[3 * p + 1] = static_cast<long long>(dot);
    out[3 * p + 2] = static_cast<long long>(emd);
  }
}

template <typename T>
int launch(const void* counts, long long n_rows, int d, const void* a_idx,
           const void* b_idx, long long n_pairs, void* out, void* stream) {
  if (n_pairs <= 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (n_pairs + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (d <= 0 || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(kWarpSize * kWarpsPerBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* cp = static_cast<const T*>(counts);
  const long long* ap = static_cast<const long long*>(a_idx);
  const long long* bp = static_cast<const long long*>(b_idx);
  long long* op = static_cast<long long*>(out);
  // 16-byte loads need every lane slice to be whole, aligned vectors: that
  // holds when d is a multiple of 32 * (16 / sizeof(T)) and the base is
  // 16-byte aligned (rows are then aligned too)
  const bool vec = d % (kWarpSize * (16 / static_cast<int>(sizeof(T)))) == 0 &&
                   reinterpret_cast<uintptr_t>(counts) % 16 == 0;
  if (vec) {
    pair_stats_kernel<T, true><<<grid, block, 0, st>>>(cp, n_rows, d, ap, bp, n_pairs, op);
  } else {
    pair_stats_kernel<T, false><<<grid, block, 0, st>>>(cp, n_rows, d, ap, bp, n_pairs, op);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mc2_pair_stats_u8(const void* counts, long long n_rows, int d,
                      const void* a_idx, const void* b_idx, long long n_pairs,
                      void* out, void* stream) {
  return launch<uint8_t>(counts, n_rows, d, a_idx, b_idx, n_pairs, out, stream);
}

int mc2_pair_stats_u16(const void* counts, long long n_rows, int d,
                       const void* a_idx, const void* b_idx, long long n_pairs,
                       void* out, void* stream) {
  return launch<uint16_t>(counts, n_rows, d, a_idx, b_idx, n_pairs, out, stream);
}

}  // extern "C"
