// Segmented closest-to-mean over a device-resident k-mer histogram store.
//
// Pairs p = 0..P-1 carry a row index rows[p], a segment id seg[p]
// (nondecreasing, in [0, C)) and a keep flag.  For each segment c, over its
// kept rows only:
//   n      = number of kept rows,  num_d = sum of their counts in bin d;
//   r_d    = floor((2 num_d + n) / (2 n))      the round-half-up mean;
//   sfloor = sum_d floor(num_d / n);
//   guard  = a float64 rounding corner in some bin (g1-g3 below): the host's
//            double-valued mean could round or truncate differently there;
//   per kept row: dist2 = 2 sum_d min(h_d, r_d),  mag = mags[row] + sfloor,
//            v = 10000 (1 - (dist2 / mag)^2)    (engine.distance_d);
//   first[c] = the first position p of the minimum v (P when no row is kept);
//   unc[c]   = guard, or a kept row whose v lies within tie_margin of the
//              minimum but whose (dist2, mag) differ from the first's.
// Where unc[c] is 0, first[c] is exactly the host's argmin: dist2 and mag are
// exact integers equal to the host's, and v is formed with explicitly rounded
// float64 operations (__ddiv_rn, __dmul_rn, __dsub_rn), so nvcc's default
// -fmad=true cannot contract 1 - frac^2 into an FMA.
//
// Replaces meshclust2_tpu/cluster/device_update.py:DeviceUpdater._closest_core
// (l. 290-364), an XLA program jitted for the TPU: segment_sum of a gathered
// [P, D] int32 block, then segment_min over double-float32 values.  The same
// computation is device_loop.py:_build_program.closest_to_mean (_mc_heavy).
//
// What bounds it on an H100: it reads every kept row twice (column sums,
// then the per-row distance), 2 P D sizeof(T) bytes (200 MB at P = 98,304,
// D = 1,024 uint8), mostly from L2 since a 10,000-row store is 10 MB, and
// does a few integer operations per byte.  The design:
//   - one block of 256 threads per segment; two binary searches over seg
//     give the block its rows, so no host-side offsets are needed;
//   - column sums: each thread owns 4-byte words of the row (4 uint8 or 2
//     uint16 bins) and keeps their sums in registers while it walks the
//     segment's rows; no atomics, the row loads are coalesced;
//   - the guards and the mean per bin in 64-bit integers, reduced over the
//     block; the mean r is stored in shared memory in the row's own type
//     (r <= max count), so the distance pass reads both operands as 16-byte
//     vectors without bank conflicts;
//   - the distance pass: one warp per kept row, shuffle reductions, lane 0
//     writes v, dist2 and mag to scratch; a block argmin (first minimum) and
//     one more sweep over the scratch for the tie guard.
// A segment far larger than the rest sets the kernel's tail (one block each);
// balancing that is later work, as are TMA and wgmma.
//
// The one-segment mode below (mc2_closest_mean_one_*) is the accumulate
// loop's closest-to-mean, the port of device_loop.py:_build_program.
// closest_to_mean / _mc_heavy (l. 1223-1355): the caller keeps the column
// sums, and the distance pass spreads over many blocks.
//
// Built by nvcc for sm_90a (ops/_build.py) and bound through ctypes: each
// entry point launches on the given stream, allocates nothing, does not
// synchronise and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpSize = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarpSize;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ long long lower_bound(const long long* __restrict__ seg,
                                                 long long n, long long key) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (seg[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

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

// sum_e min(x_e, y_e) over the bins packed in one 32-bit word.
template <typename T>
__device__ __forceinline__ unsigned min_sum_word(unsigned x, unsigned y) {
  constexpr int kBits = 8 * sizeof(T);
  constexpr unsigned kMask = (1u << kBits) - 1u;
  unsigned s = 0;
#pragma unroll
  for (int k = 0; k < 4 / static_cast<int>(sizeof(T)); ++k) {
    s += min((x >> (k * kBits)) & kMask, (y >> (k * kBits)) & kMask);
  }
  return s;
}

// VEC: every row starts on a 16-byte boundary (base aligned, D sizeof(T) a
// multiple of 16): 4-byte words for the column sums, 16-byte vectors for the
// distance pass.  Otherwise both passes read single bins.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
closest_mean_kernel(const T* __restrict__ counts, int d,
                    const double* __restrict__ mags,
                    const long long* __restrict__ rows,
                    const long long* __restrict__ seg,
                    const unsigned char* __restrict__ keep, long long n_pairs,
                    long long maxc, double tie_margin,
                    double* __restrict__ v_out, long long* __restrict__ d2_out,
                    long long* __restrict__ mag_out,
                    long long* __restrict__ first_out,
                    unsigned char* __restrict__ unc_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* num_s = reinterpret_cast<long long*>(smem);  // [d] column sums
  T* r_s = reinterpret_cast<T*>(smem + sizeof(long long) * d);  // [d] mean
  __shared__ long long red[kWarps];
  __shared__ double best_v_s[kWarps];
  __shared__ long long best_p_s[kWarps];
  __shared__ long long bounds[2];

  const long long c = blockIdx.x;
  const int lane = threadIdx.x & (kWarpSize - 1);
  const int warp = threadIdx.x / kWarpSize;
  if (threadIdx.x == 0) bounds[0] = lower_bound(seg, n_pairs, c);
  if (threadIdx.x == 1) bounds[1] = lower_bound(seg, n_pairs, c + 1);
  __syncthreads();
  const long long lo = bounds[0];
  const long long hi = bounds[1];

  // 1. kept-row count and column sums
  long long cnt = 0;
  for (long long p = lo + threadIdx.x; p < hi; p += kThreads) cnt += keep[p];
  cnt = block_sum(cnt, red);
  if (VEC) {
    constexpr int kPer = 4 / sizeof(T);
    constexpr int kBits = 8 * sizeof(T);
    constexpr unsigned kMask = (1u << kBits) - 1u;
    const int words = d / kPer;
    for (int w = threadIdx.x; w < words; w += kThreads) {
      long long acc[kPer] = {};
#pragma unroll 4
      for (long long p = lo; p < hi; ++p) {
        const unsigned* row = reinterpret_cast<const unsigned*>(counts + rows[p] * d);
        const unsigned x = keep[p] ? __ldg(row + w) : 0u;
#pragma unroll
        for (int k = 0; k < kPer; ++k) acc[k] += (x >> (k * kBits)) & kMask;
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) num_s[w * kPer + k] = acc[k];
    }
  } else {
    for (int e = threadIdx.x; e < d; e += kThreads) {
      long long acc = 0;
      for (long long p = lo; p < hi; ++p) {
        if (keep[p]) acc += counts[rows[p] * d + e];
      }
      num_s[e] = acc;
    }
  }
  __syncthreads();

  // 2. the integer mean, sum of floors and rounding-corner guards per bin
  // (device_update.py:314-331).  For integer rem and real t, rem <= t iff
  // rem <= floor(t), so comparing against the floored shifts is exact.
  const long long den = cnt > 0 ? cnt : 1;
  long long sfloor = 0;
  int guard = 0;
  for (int e = threadIdx.x; e < d; e += kThreads) {
    const long long num = num_s[e];
    const long long q = num / den;
    const long long rem = num - q * den;
    sfloor += q;
    const long long half = 2 * rem - den;
    const long long half_abs = half < 0 ? -half : half;
    const bool g1 = half_abs != 0 && half_abs <= (((q + 2) * den) >> 51);
    const bool g2 = rem != 0 && rem <= (((q + 2) * den) >> 52);
    const bool g3 = rem != 0 && (den - rem) <= (((q + maxc + 2) * den) >> 52);
    guard |= g1 | g2 | g3;
    r_s[e] = static_cast<T>((2 * num + den) / (2 * den));
  }
  sfloor = block_sum(sfloor, red);  // its barriers also publish r_s
  const int seg_guard = __syncthreads_or(guard);

  // 3. one warp per kept row: dist2, mag, v; the warp's first minimum
  double best_v = __longlong_as_double(0x7ff0000000000000LL);  // +inf
  long long best_p = n_pairs;
  for (long long p = lo + warp; p < hi; p += kWarps) {
    if (!keep[p]) continue;  // uniform across the warp
    const long long row = rows[p];
    long long acc = 0;
    if (VEC) {
      const uint4* h4 = reinterpret_cast<const uint4*>(counts + row * d);
      const uint4* r4 = reinterpret_cast<const uint4*>(r_s);
      const int chunks = d * static_cast<int>(sizeof(T)) / 16;
      for (int ch = lane; ch < chunks; ch += kWarpSize) {
        const uint4 x = __ldg(h4 + ch);
        const uint4 y = r4[ch];
        acc += min_sum_word<T>(x.x, y.x) + min_sum_word<T>(x.y, y.y) +
               min_sum_word<T>(x.z, y.z) + min_sum_word<T>(x.w, y.w);
      }
    } else {
      const T* h = counts + row * d;
      for (int e = lane; e < d; e += kWarpSize) {
        acc += min(static_cast<unsigned>(h[e]), static_cast<unsigned>(r_s[e]));
      }
    }
    const long long dist2 = 2 * warp_sum(acc);
    const long long mag = static_cast<long long>(mags[row]) + sfloor;
    const double frac = __ddiv_rn(static_cast<double>(dist2), static_cast<double>(mag));
    const double v = __dmul_rn(10000.0, __dsub_rn(1.0, __dmul_rn(frac, frac)));
    if (lane == 0) {
      v_out[p] = v;
      d2_out[p] = dist2;
      mag_out[p] = mag;
    }
    if (v < best_v) {  // positions rise within the warp: first strict minimum
      best_v = v;
      best_p = p;
    }
  }
  if (lane == 0) {
    best_v_s[warp] = best_v;
    best_p_s[warp] = best_p;
  }
  __syncthreads();  // also publishes the scratch rows to the whole block
  double mv = best_v_s[0];
  long long fp = best_p_s[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    const double wv = best_v_s[w];
    const long long wp = best_p_s[w];
    if (wv < mv || (wv == mv && wp < fp)) {
      mv = wv;
      fp = wp;
    }
  }

  // 4. tie guard: kept rows near the minimum whose integers differ from the
  // first's (device_update.py:354-363)
  int tie = 0;
  if (fp < n_pairs) {
    const long long fd2 = d2_out[fp];
    const long long fmg = mag_out[fp];
    const double thr = tie_margin * fmax(fabs(mv), 1.0);
    for (long long p = lo + threadIdx.x; p < hi; p += kThreads) {
      if (!keep[p]) continue;
      const bool near = fabs(v_out[p] - mv) <= thr;
      const bool same = d2_out[p] == fd2 && mag_out[p] == fmg;
      tie |= near && !same;
    }
  }
  tie = __syncthreads_or(tie);
  if (threadIdx.x == 0) {
    first_out[c] = fp;
    unc_out[c] = (seg_guard || tie) ? 1 : 0;
  }
}

template <typename T>
int launch(const void* counts, int d, const void* mags, const void* rows,
           const void* seg, const void* keep, long long n_pairs,
           long long n_segs, long long maxc, double tie_margin, void* v_out,
           void* d2_out, void* mag_out, void* first_out, void* unc_out,
           void* stream) {
  if (n_segs <= 0) return static_cast<int>(cudaSuccess);
  if (d <= 0 || n_segs > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shm = static_cast<size_t>(d) * (sizeof(long long) + sizeof(T));
  const bool vec = (static_cast<size_t>(d) * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(counts) % 16 == 0;
  auto kernel = vec ? &closest_mean_kernel<T, true> : &closest_mean_kernel<T, false>;
  if (shm > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shm));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(static_cast<unsigned>(n_segs)), dim3(kThreads), shm,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(counts), d, static_cast<const double*>(mags),
      static_cast<const long long*>(rows), static_cast<const long long*>(seg),
      static_cast<const unsigned char*>(keep), n_pairs, maxc, tie_margin,
      static_cast<double*>(v_out), static_cast<long long*>(d2_out),
      static_cast<long long*>(mag_out), static_cast<long long*>(first_out),
      static_cast<unsigned char*>(unc_out));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// One segment over many blocks (the accumulate loop's open cluster).
//
// The caller supplies the segment's int64 column sums col_sum [d] and kept
// row count (*count), which the accumulate loop keeps as it absorbs rows,
// so the column-sum pass goes.  closest_one_dist_kernel spreads the
// distance pass over min(ceil(P / kWarps), max_blocks) blocks: each block
// rebuilds the mean r from col_sum (d int64 reads, from L2), then one warp
// per kept row (rows strided over all the grid's warps) forms dist2, mag and
// v as in the segmented kernel and keeps its first minimum; each block
// writes its (v, position) minimum to part_v / part_p.  A float64 minimum
// with its position does not fit one atomic word, so closest_one_final_kernel,
// one block, takes the first minimum over the partials (smaller v, then
// smaller position), evaluates the g1-g3 guards from col_sum, and sweeps
// the scratch rows for the tie guard.  The results are bit for bit those of
// the segmented kernel on the same rows with one segment.

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
closest_one_dist_kernel(const T* __restrict__ counts, int d,
                        const double* __restrict__ mags,
                        const long long* __restrict__ rows,
                        const unsigned char* __restrict__ keep, long long n_pairs,
                        const long long* __restrict__ col_sum,
                        const long long* __restrict__ count,
                        double* __restrict__ v_out, long long* __restrict__ d2_out,
                        long long* __restrict__ mag_out,
                        double* __restrict__ part_v, long long* __restrict__ part_p) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* r_s = reinterpret_cast<T*>(smem);  // [d] mean
  __shared__ long long red[kWarps];
  __shared__ double best_v_s[kWarps];
  __shared__ long long best_p_s[kWarps];
  const int lane = threadIdx.x & (kWarpSize - 1);
  const int warp = threadIdx.x / kWarpSize;

  const long long cnt = *count;
  const long long den = cnt > 0 ? cnt : 1;
  long long sfloor = 0;
  for (int e = threadIdx.x; e < d; e += kThreads) {
    const long long num = col_sum[e];
    sfloor += num / den;
    r_s[e] = static_cast<T>((2 * num + den) / (2 * den));
  }
  sfloor = block_sum(sfloor, red);  // its barriers also publish r_s

  double best_v = __longlong_as_double(0x7ff0000000000000LL);  // +inf
  long long best_p = n_pairs;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long p = static_cast<long long>(blockIdx.x) * kWarps + warp; p < n_pairs;
       p += stride) {
    if (!keep[p]) continue;  // uniform across the warp
    const long long row = rows[p];
    long long acc = 0;
    if (VEC) {
      const uint4* h4 = reinterpret_cast<const uint4*>(counts + row * d);
      const uint4* r4 = reinterpret_cast<const uint4*>(r_s);
      const int chunks = d * static_cast<int>(sizeof(T)) / 16;
      for (int ch = lane; ch < chunks; ch += kWarpSize) {
        const uint4 x = __ldg(h4 + ch);
        const uint4 y = r4[ch];
        acc += min_sum_word<T>(x.x, y.x) + min_sum_word<T>(x.y, y.y) +
               min_sum_word<T>(x.z, y.z) + min_sum_word<T>(x.w, y.w);
      }
    } else {
      const T* h = counts + row * d;
      for (int e = lane; e < d; e += kWarpSize) {
        acc += min(static_cast<unsigned>(h[e]), static_cast<unsigned>(r_s[e]));
      }
    }
    const long long dist2 = 2 * warp_sum(acc);
    const long long mag = static_cast<long long>(mags[row]) + sfloor;
    const double frac = __ddiv_rn(static_cast<double>(dist2), static_cast<double>(mag));
    const double v = __dmul_rn(10000.0, __dsub_rn(1.0, __dmul_rn(frac, frac)));
    if (lane == 0) {
      v_out[p] = v;
      d2_out[p] = dist2;
      mag_out[p] = mag;
    }
    if (v < best_v) {  // positions rise within the warp: first strict minimum
      best_v = v;
      best_p = p;
    }
  }
  if (lane == 0) {
    best_v_s[warp] = best_v;
    best_p_s[warp] = best_p;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double mv = best_v_s[0];
    long long fp = best_p_s[0];
    for (int w = 1; w < kWarps; ++w) {
      if (best_v_s[w] < mv || (best_v_s[w] == mv && best_p_s[w] < fp)) {
        mv = best_v_s[w];
        fp = best_p_s[w];
      }
    }
    part_v[blockIdx.x] = mv;
    part_p[blockIdx.x] = fp;
  }
}

__global__ void __launch_bounds__(kThreads)
closest_one_final_kernel(const unsigned char* __restrict__ keep, long long n_pairs,
                         int d, const long long* __restrict__ col_sum,
                         const long long* __restrict__ count, long long maxc,
                         double tie_margin, const double* __restrict__ v_out,
                         const long long* __restrict__ d2_out,
                         const long long* __restrict__ mag_out,
                         const double* __restrict__ part_v,
                         const long long* __restrict__ part_p, int n_parts,
                         long long* __restrict__ first_out,
                         unsigned char* __restrict__ unc_out) {
  __shared__ double best_v_s[kWarps];
  __shared__ long long best_p_s[kWarps];
  const int lane = threadIdx.x & (kWarpSize - 1);
  const int warp = threadIdx.x / kWarpSize;

  // the rounding-corner guards, as in step 2 of closest_mean_kernel
  const long long cnt = *count;
  const long long den = cnt > 0 ? cnt : 1;
  int guard = 0;
  for (int e = threadIdx.x; e < d; e += kThreads) {
    const long long num = col_sum[e];
    const long long q = num / den;
    const long long rem = num - q * den;
    const long long half = 2 * rem - den;
    const long long half_abs = half < 0 ? -half : half;
    const bool g1 = half_abs != 0 && half_abs <= (((q + 2) * den) >> 51);
    const bool g2 = rem != 0 && rem <= (((q + 2) * den) >> 52);
    const bool g3 = rem != 0 && (den - rem) <= (((q + maxc + 2) * den) >> 52);
    guard |= g1 | g2 | g3;
  }
  const int seg_guard = __syncthreads_or(guard);

  // the first minimum over the blocks' partials
  double mv = __longlong_as_double(0x7ff0000000000000LL);  // +inf
  long long fp = n_pairs;
  for (int i = threadIdx.x; i < n_parts; i += kThreads) {
    const double v = part_v[i];
    const long long p = part_p[i];
    if (v < mv || (v == mv && p < fp)) {
      mv = v;
      fp = p;
    }
  }
  for (int o = kWarpSize / 2; o > 0; o >>= 1) {
    const double ov = __shfl_xor_sync(kFullMask, mv, o);
    const long long op = __shfl_xor_sync(kFullMask, fp, o);
    if (ov < mv || (ov == mv && op < fp)) {
      mv = ov;
      fp = op;
    }
  }
  if (lane == 0) {
    best_v_s[warp] = mv;
    best_p_s[warp] = fp;
  }
  __syncthreads();
  mv = best_v_s[0];
  fp = best_p_s[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    if (best_v_s[w] < mv || (best_v_s[w] == mv && best_p_s[w] < fp)) {
      mv = best_v_s[w];
      fp = best_p_s[w];
    }
  }

  // tie guard over every kept row (device_update.py:354-363)
  int tie = 0;
  if (fp < n_pairs) {
    const long long fd2 = d2_out[fp];
    const long long fmg = mag_out[fp];
    const double thr = tie_margin * fmax(fabs(mv), 1.0);
    for (long long p = threadIdx.x; p < n_pairs; p += kThreads) {
      if (!keep[p]) continue;
      const bool near = fabs(v_out[p] - mv) <= thr;
      const bool same = d2_out[p] == fd2 && mag_out[p] == fmg;
      tie |= near && !same;
    }
  }
  tie = __syncthreads_or(tie);
  if (threadIdx.x == 0) {
    first_out[0] = fp;
    unc_out[0] = (seg_guard || tie) ? 1 : 0;
  }
}

template <typename T>
int launch_one(const void* counts, int d, const void* mags, const void* rows,
               const void* keep, long long n_pairs, const void* col_sum,
               const void* count, long long maxc, double tie_margin, int max_blocks,
               void* v_out, void* d2_out, void* mag_out, void* part_v, void* part_p,
               void* first_out, void* unc_out, void* stream) {
  if (d <= 0 || n_pairs < 0 || max_blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long want = (n_pairs + kWarps - 1) / kWarps;
  const int n_parts = static_cast<int>(want < max_blocks ? want : max_blocks);
  if (n_parts > 0) {
    const size_t shm = static_cast<size_t>(d) * sizeof(T);
    const bool vec = (static_cast<size_t>(d) * sizeof(T)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(counts) % 16 == 0;
    auto kernel = vec ? &closest_one_dist_kernel<T, true>
                      : &closest_one_dist_kernel<T, false>;
    if (shm > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shm));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kernel<<<dim3(static_cast<unsigned>(n_parts)), dim3(kThreads), shm, st>>>(
        static_cast<const T*>(counts), d, static_cast<const double*>(mags),
        static_cast<const long long*>(rows), static_cast<const unsigned char*>(keep),
        n_pairs, static_cast<const long long*>(col_sum),
        static_cast<const long long*>(count), static_cast<double*>(v_out),
        static_cast<long long*>(d2_out), static_cast<long long*>(mag_out),
        static_cast<double*>(part_v), static_cast<long long*>(part_p));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  closest_one_final_kernel<<<1, kThreads, 0, st>>>(
      static_cast<const unsigned char*>(keep), n_pairs, d,
      static_cast<const long long*>(col_sum), static_cast<const long long*>(count), maxc,
      tie_margin, static_cast<const double*>(v_out),
      static_cast<const long long*>(d2_out), static_cast<const long long*>(mag_out),
      static_cast<const double*>(part_v), static_cast<const long long*>(part_p), n_parts,
      static_cast<long long*>(first_out), static_cast<unsigned char*>(unc_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mc2_closest_mean_one_u8(const void* counts, int d, const void* mags,
                            const void* rows, const void* keep, long long n_pairs,
                            const void* col_sum, const void* count, long long maxc,
                            double tie_margin, int max_blocks, void* v_out,
                            void* d2_out, void* mag_out, void* part_v, void* part_p,
                            void* first_out, void* unc_out, void* stream) {
  return launch_one<uint8_t>(counts, d, mags, rows, keep, n_pairs, col_sum, count, maxc,
                             tie_margin, max_blocks, v_out, d2_out, mag_out, part_v,
                             part_p, first_out, unc_out, stream);
}

int mc2_closest_mean_one_u16(const void* counts, int d, const void* mags,
                             const void* rows, const void* keep, long long n_pairs,
                             const void* col_sum, const void* count, long long maxc,
                             double tie_margin, int max_blocks, void* v_out,
                             void* d2_out, void* mag_out, void* part_v, void* part_p,
                             void* first_out, void* unc_out, void* stream) {
  return launch_one<uint16_t>(counts, d, mags, rows, keep, n_pairs, col_sum, count,
                              maxc, tie_margin, max_blocks, v_out, d2_out, mag_out,
                              part_v, part_p, first_out, unc_out, stream);
}


int mc2_closest_mean_u8(const void* counts, int d, const void* mags,
                        const void* rows, const void* seg, const void* keep,
                        long long n_pairs, long long n_segs, long long maxc,
                        double tie_margin, void* v_out, void* d2_out,
                        void* mag_out, void* first_out, void* unc_out,
                        void* stream) {
  return launch<uint8_t>(counts, d, mags, rows, seg, keep, n_pairs, n_segs, maxc,
                         tie_margin, v_out, d2_out, mag_out, first_out, unc_out,
                         stream);
}

int mc2_closest_mean_u16(const void* counts, int d, const void* mags,
                         const void* rows, const void* seg, const void* keep,
                         long long n_pairs, long long n_segs, long long maxc,
                         double tie_margin, void* v_out, void* d2_out,
                         void* mag_out, void* first_out, void* unc_out,
                         void* stream) {
  return launch<uint16_t>(counts, d, mags, rows, seg, keep, n_pairs, n_segs, maxc,
                          tie_margin, v_out, d2_out, mag_out, first_out, unc_out,
                          stream);
}

}  // extern "C"
