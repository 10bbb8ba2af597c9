// The decision half of one accumulate step: for the W candidates of the
// open cluster's length window, given their float64 GLM sums s and dists
// (from the pair-statistics kernel, derive_singles and the classifier
// epilogue, candidate as side a and the center as side b):
//   pos[p]   = s[p] >= pos_edge                  (round(prob) > 0)
//   bit 1    = some |s[p] - pos_edge| <= margin * max(|s[p]|, |pos_edge|, 1)
//   best     = the first position of the largest dist (W when W = 0)
//   bit 2    = some candidate within tie_margin * max(|dist[best]|, 1) of
//              the best whose (stats, mags, selfdot, lens, stddev) differ
//              from the best's: the host's float64 could rank them apart
//   npos     = the number of positives
//   colsum   = the int64 [D] column sum of the positive rows
// info = (bits, npos, best).  Where bits is 0 the positives and the best
// are the host's (Trainer::get_close, Trainer.cpp:22-71): the gates are
// formed with explicitly rounded float64 operations (__dsub_rn, __dmul_rn),
// so nvcc's -fmad=true changes nothing, and the plain version
// (ops/window_absorb.py:window_absorb_ref) gives the same bits.
//
// Replaces the decision half of meshclust2_tpu/cluster/device_loop.py:
// _build_program.scan_window._chunk_heavy (l. 1112-1209), an XLA program
// jitted for the TPU over 2,048-row chunks in double-float32 with
// propagated error bounds.  Native float64 needs no error terms; one
// launch covers the whole window, so the cross-chunk tie guard (cause 4)
// is not needed: the tie guard compares every candidate with the global
// best.
//
// What bounds it on an H100: the column sum reads each positive row once,
// W D sizeof(T) bytes at most (2 MB at W = 2,048, D = 1,024 uint8), from L2
// (a 10,000-row store is 10 MB); the decisions read ~80 bytes per
// candidate.  At the accumulate loop's sizes the launch itself dominates.
// The design:
//   - block 0 makes the decisions: one pass for the gates, the positive
//     count and the first maximum (per thread, then over the block), one
//     more pass for the tie guard against the best's signature;
//   - blocks 1.. each own kRowsPerTile candidates and sum the positive rows
//     in registers, each thread over 4-byte words of the row (coalesced),
//     then add their partial sums to colsum with integer atomics: integer
//     addition commutes, so the result does not depend on their order.
//     They recompute s >= pos_edge themselves rather than wait for block 0.
// Built by nvcc for sm_90a (ops/_build.py) and bound through ctypes: each
// entry point launches on the given stream, allocates nothing (colsum must
// come zeroed), does not synchronise and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpSize = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarpSize;
constexpr int kRowsPerTile = 64;  // 64 * 65535 < 2^31: a word's sums fit
constexpr unsigned kFullMask = 0xffffffffu;

// (v, p) is better than (w, q): larger v, or the same v at an earlier p.
// An empty slot (p < 0) loses to any candidate.
__device__ __forceinline__ bool better(double v, long long p, double w, long long q) {
  if (p < 0) return false;
  if (q < 0) return true;
  return v > w || (v == w && p < q);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
window_absorb_kernel(const T* __restrict__ counts, int d,
                     const long long* __restrict__ rows, long long n_cand,
                     const double* __restrict__ s, const double* __restrict__ dist,
                     const long long* __restrict__ stats,
                     const double* __restrict__ mags,
                     const double* __restrict__ selfdot,
                     const double* __restrict__ lens,
                     const double* __restrict__ stddevs, double pos_edge,
                     double margin, double tie_margin,
                     unsigned char* __restrict__ pos_out,
                     unsigned long long* __restrict__ colsum,
                     long long* __restrict__ info) {
  if (blockIdx.x > 0) {
    // column sums of the positive rows of one tile
    const long long lo = static_cast<long long>(blockIdx.x - 1) * kRowsPerTile;
    const long long hi = min(lo + kRowsPerTile, n_cand);
    if (VEC) {
      constexpr int kPer = 4 / sizeof(T);
      constexpr int kBits = 8 * sizeof(T);
      constexpr unsigned kMask = (1u << kBits) - 1u;
      const int words = d / kPer;
      for (int w = threadIdx.x; w < words; w += kThreads) {
        unsigned acc[kPer] = {};
        for (long long p = lo; p < hi; ++p) {
          if (!(s[p] >= pos_edge)) continue;  // uniform across the block
          const unsigned x =
              __ldg(reinterpret_cast<const unsigned*>(counts + rows[p] * d) + w);
#pragma unroll
          for (int k = 0; k < kPer; ++k) acc[k] += (x >> (k * kBits)) & kMask;
        }
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          if (acc[k]) atomicAdd(colsum + w * kPer + k, static_cast<unsigned long long>(acc[k]));
        }
      }
    } else {
      for (int e = threadIdx.x; e < d; e += kThreads) {
        unsigned acc = 0;
        for (long long p = lo; p < hi; ++p) {
          if (s[p] >= pos_edge) acc += counts[rows[p] * d + e];
        }
        if (acc) atomicAdd(colsum + e, static_cast<unsigned long long>(acc));
      }
    }
    return;
  }

  __shared__ double red_v[kWarps];
  __shared__ long long red_p[kWarps];
  __shared__ long long red_n[kWarps];
  const int lane = threadIdx.x & (kWarpSize - 1);
  const int warp = threadIdx.x / kWarpSize;
  const double edge_abs = fabs(pos_edge);

  // 1. gates, positives, and each thread's first maximum
  int unc = 0;
  long long npos = 0;
  double bv = 0.0;
  long long bp = -1;
  for (long long p = threadIdx.x; p < n_cand; p += kThreads) {
    const double sp = s[p];
    const bool pos = sp >= pos_edge;
    pos_out[p] = pos ? 1 : 0;
    npos += pos;
    const double scale = fmax(fmax(fabs(sp), edge_abs), 1.0);
    unc |= fabs(__dsub_rn(sp, pos_edge)) <= __dmul_rn(margin, scale);
    const double v = dist[p];
    if (bp < 0 || v > bv) {  // positions rise within a thread: first maximum
      bv = v;
      bp = p;
    }
  }
  for (int o = kWarpSize / 2; o > 0; o >>= 1) {
    const double ov = __shfl_xor_sync(kFullMask, bv, o);
    const long long op = __shfl_xor_sync(kFullMask, bp, o);
    if (better(ov, op, bv, bp)) {
      bv = ov;
      bp = op;
    }
    npos += __shfl_xor_sync(kFullMask, npos, o);
  }
  if (lane == 0) {
    red_v[warp] = bv;
    red_p[warp] = bp;
    red_n[warp] = npos;
  }
  unc = __syncthreads_or(unc);  // also publishes red_*
  bv = red_v[0];
  bp = red_p[0];
  npos = red_n[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    if (better(red_v[w], red_p[w], bv, bp)) {
      bv = red_v[w];
      bp = red_p[w];
    }
    npos += red_n[w];
  }

  // 2. tie guard: candidates near the best whose inputs differ from its
  int tie = 0;
  if (bp >= 0) {
    const long long br = rows[bp];
    const long long b0 = stats[3 * bp], b1 = stats[3 * bp + 1], b2 = stats[3 * bp + 2];
    const double bm = mags[br], bs = selfdot[br], bl = lens[br], bd = stddevs[br];
    const double thr = __dmul_rn(tie_margin, fmax(fabs(bv), 1.0));
    for (long long p = threadIdx.x; p < n_cand; p += kThreads) {
      const double v = dist[p];
      if (!(fabs(__dsub_rn(v, bv)) <= thr)) continue;
      const long long r = rows[p];
      const bool same = v == bv && stats[3 * p] == b0 && stats[3 * p + 1] == b1 &&
                        stats[3 * p + 2] == b2 && mags[r] == bm && selfdot[r] == bs &&
                        lens[r] == bl && stddevs[r] == bd;
      tie |= !same;
    }
  }
  tie = __syncthreads_or(tie);
  if (threadIdx.x == 0) {
    info[0] = (unc ? 1 : 0) | (tie ? 2 : 0);
    info[1] = npos;
    info[2] = bp >= 0 ? bp : n_cand;
  }
}

template <typename T>
int launch(const void* counts, int d, const void* rows, long long n_cand,
           const void* s, const void* dist, const void* stats, const void* mags,
           const void* selfdot, const void* lens, const void* stddevs,
           double pos_edge, double margin, double tie_margin, void* pos_out,
           void* colsum, void* info, void* stream) {
  if (d <= 0 || n_cand < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (n_cand + kRowsPerTile - 1) / kRowsPerTile;
  if (tiles + 1 > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (static_cast<size_t>(d) * sizeof(T)) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(counts) % 4 == 0;
  auto kernel = vec ? &window_absorb_kernel<T, true> : &window_absorb_kernel<T, false>;
  kernel<<<dim3(static_cast<unsigned>(tiles + 1)), dim3(kThreads), 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(counts), d, static_cast<const long long*>(rows), n_cand,
      static_cast<const double*>(s), static_cast<const double*>(dist),
      static_cast<const long long*>(stats), static_cast<const double*>(mags),
      static_cast<const double*>(selfdot), static_cast<const double*>(lens),
      static_cast<const double*>(stddevs), pos_edge, margin, tie_margin,
      static_cast<unsigned char*>(pos_out), static_cast<unsigned long long*>(colsum),
      static_cast<long long*>(info));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mc2_window_absorb_u8(const void* counts, int d, const void* rows, long long n_cand,
                         const void* s, const void* dist, const void* stats,
                         const void* mags, const void* selfdot, const void* lens,
                         const void* stddevs, double pos_edge, double margin,
                         double tie_margin, void* pos_out, void* colsum, void* info,
                         void* stream) {
  return launch<uint8_t>(counts, d, rows, n_cand, s, dist, stats, mags, selfdot, lens,
                         stddevs, pos_edge, margin, tie_margin, pos_out, colsum, info,
                         stream);
}

int mc2_window_absorb_u16(const void* counts, int d, const void* rows, long long n_cand,
                          const void* s, const void* dist, const void* stats,
                          const void* mags, const void* selfdot, const void* lens,
                          const void* stddevs, double pos_edge, double margin,
                          double tie_margin, void* pos_out, void* colsum, void* info,
                          void* stream) {
  return launch<uint16_t>(counts, d, rows, n_cand, s, dist, stats, mags, selfdot, lens,
                          stddevs, pos_edge, margin, tie_margin, pos_out, colsum, info,
                          stream);
}

}  // extern "C"
