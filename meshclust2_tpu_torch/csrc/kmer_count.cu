// The k-mer histogram build on the card: per record, its pseudocounted,
// saturating 4^k k-mer counts and its pseudocounted 1-mer counts.
//
// For record r (its codes seq = codes + offsets[r], values 0..3 inside its
// segments; its segments (start, end inclusive) segs[2 g], segs[2 g + 1]
// for g in [seg_offsets[r], seg_offsets[r + 1]), relative to seq):
//   counts[r, x] = min(1 + #windows of k codes with big-endian base-4 index
//                  x lying wholly inside one segment, sat);
//   ones[r, b]   = 1 + #segment positions holding base b, unsaturated;
// with sat = min(the datatype's max, the natural width's max), counts
// written at the natural width (uint8/uint16/uint32).  This is what the
// native counter computes (native/count.cpp:count_kmers_batch) and the
// reference (Loader.cpp:137-179, KmerHashTable.cpp:133-256).  Validity
// follows the segments, not the codes: io/fasta.py splits valid runs at
// 1 Mbp, so a window across a split holds valid codes and must not count.
//
// Replaces meshclust2_tpu/parallel/mesh.py:sharded_histogram_build.one_seq
// (l. 200-218), an XLA program sharded over a TPU mesh that scatter-adds
// over records padded to the longest one with -1 separators.  Here the
// records stay ragged (native/__init__.py:_pack_records), so one long
// record does not pad the others.
//
// What bounds it on an H100: the bytes, each code read once (~1 byte a
// window) and each count written once (4^k a record at its width), about
// 6.6 us at the 10k bench set (22 MB at 3.35 TB/s); the index sweep is k
// shifts a window.  The first design, one block of 256 threads per record
// (several records a block, by stride, when the grid is capped):
//   - the histogram as uint32 in shared memory for k <= 7 (64 KB at k = 7,
//     above 48 KB by the dynamic shared-memory attribute), else a uint32
//     row of global scratch per block (k >= 8: 256 KB a row and up);
//   - each thread takes the positions p = start + t, start + t + 256, ...
//     of each segment: neighbouring threads on neighbouring bytes; it
//     counts the base at p in registers and, when p + k - 1 <= end, forms
//     the window's index by a Horner sweep over its k codes and adds one to
//     its bin with an atomic (a homopolymer run sends every window to one
//     bin: those atomics serialise, measured in chip_smoke.py (k));
//   - the 1-mers reduced by warp shuffles, then four shared counters;
//   - the saturating write-out at the natural width, coalesced.
//
// Built by nvcc for sm_90a (ops/_build.py) and bound through ctypes: the
// entry point launches on the given stream, allocates nothing, does not
// synchronise and returns the launch's error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpSize = 32;
constexpr unsigned kFullMask = 0xffffffffu;
// the largest k whose uint32 histogram a block keeps in shared memory
constexpr int kSharedK = 7;

struct CountArgs {
  const signed char* codes;
  const long long* offsets;      // [n + 1] into codes
  const long long* segs;         // [2 G]: (start, end inclusive) per segment
  const long long* seg_offsets;  // [n + 1] into the segments
  long long n;
  int k;
  unsigned long long sat;
  void* counts;        // [n, 4^k] at the natural width
  long long* ones;     // [n, 4]
  unsigned* scratch;   // the global instantiation's [gridDim.x, 4^k]
};

template <typename T, bool SHARED>
__global__ void __launch_bounds__(kThreads) kmer_count_kernel(const CountArgs a) {
  extern __shared__ __align__(16) unsigned smem[];
  __shared__ unsigned long long one_s[4];
  const int k = a.k;
  const long long D = 1LL << (2 * k);
  const int lane = threadIdx.x & (kWarpSize - 1);
  unsigned* hist = SHARED ? smem : a.scratch + static_cast<long long>(blockIdx.x) * D;
  for (long long r = blockIdx.x; r < a.n; r += gridDim.x) {
    for (long long e = threadIdx.x; e < D; e += kThreads) hist[e] = 0;
    if (threadIdx.x < 4) one_s[threadIdx.x] = 0;
    __syncthreads();
    const signed char* seq = a.codes + a.offsets[r];
    unsigned b0 = 0, b1 = 0, b2 = 0, b3 = 0;
    for (long long g = a.seg_offsets[r]; g < a.seg_offsets[r + 1]; ++g) {
      const long long start = a.segs[2 * g];
      const long long end = a.segs[2 * g + 1];
      for (long long p = start + threadIdx.x; p <= end; p += kThreads) {
        const unsigned c = static_cast<unsigned>(seq[p]);
        b0 += c == 0;
        b1 += c == 1;
        b2 += c == 2;
        b3 += c == 3;
        if (p + k - 1 <= end) {
          unsigned x = c;
          for (int j = 1; j < k; ++j) x = (x << 2) | static_cast<unsigned>(seq[p + j]);
          atomicAdd(&hist[x], 1u);
        }
      }
    }
#pragma unroll
    for (int o = kWarpSize / 2; o > 0; o >>= 1) {
      b0 += __shfl_xor_sync(kFullMask, b0, o);
      b1 += __shfl_xor_sync(kFullMask, b1, o);
      b2 += __shfl_xor_sync(kFullMask, b2, o);
      b3 += __shfl_xor_sync(kFullMask, b3, o);
    }
    if (lane == 0) {
      atomicAdd(&one_s[0], static_cast<unsigned long long>(b0));
      atomicAdd(&one_s[1], static_cast<unsigned long long>(b1));
      atomicAdd(&one_s[2], static_cast<unsigned long long>(b2));
      atomicAdd(&one_s[3], static_cast<unsigned long long>(b3));
    }
    __syncthreads();  // every window and base counted
    T* out = static_cast<T*>(a.counts) + r * D;
    for (long long e = threadIdx.x; e < D; e += kThreads) {
      const unsigned long long v = static_cast<unsigned long long>(hist[e]) + 1;
      out[e] = static_cast<T>(v < a.sat ? v : a.sat);
    }
    if (threadIdx.x < 4) a.ones[4 * r + threadIdx.x] = static_cast<long long>(one_s[threadIdx.x]) + 1;
    __syncthreads();  // the histogram is read no more before the next record
  }
}

template <typename T>
int launch(const CountArgs& a, long long scratch_rows, cudaStream_t stream) {
  const long long D = 1LL << (2 * a.k);
  if (a.k <= kSharedK) {
    const size_t shm = static_cast<size_t>(D) * sizeof(unsigned);
    auto kernel = &kmer_count_kernel<T, true>;
    if (shm > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shm));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const long long grid = a.n < 0x7fffffffLL ? a.n : 0x7fffffffLL;
    kernel<<<dim3(static_cast<unsigned>(grid)), dim3(kThreads), shm, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (a.scratch == nullptr || scratch_rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long grid = a.n < scratch_rows ? a.n : scratch_rows;
  kmer_count_kernel<T, false><<<dim3(static_cast<unsigned>(grid)), dim3(kThreads), 0,
                                stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The largest k whose histogram a block keeps in shared memory; above it
// the kernel takes scratch rows (uint32 [scratch_rows, 4^k]).
int mc2_kmer_shared_k() { return kSharedK; }

// codes int8 (values 0..3 inside the segments); offsets, seg_offsets int64
// [n + 1]; segs int64 [2 G]; width 1, 2 or 4 bytes (the counts' natural
// width); counts [n, 4^k] at that width; ones int64 [n, 4]; scratch uint32
// [scratch_rows, 4^k] when k > mc2_kmer_shared_k(), else unused (may be
// null).  1 <= k <= 15, sat <= the width's max.
int mc2_kmer_count(const void* codes, const void* offsets, const void* segs,
                   const void* seg_offsets, long long n, int k, unsigned long long sat,
                   int width, void* counts, void* ones, void* scratch,
                   long long scratch_rows, void* stream) {
  if (n < 0 || k < 1 || k > 15 || sat < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const CountArgs a{static_cast<const signed char*>(codes),
                    static_cast<const long long*>(offsets),
                    static_cast<const long long*>(segs),
                    static_cast<const long long*>(seg_offsets),
                    n,
                    k,
                    sat,
                    counts,
                    static_cast<long long*>(ones),
                    static_cast<unsigned*>(scratch)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 1:
      return sat > 0xffull ? static_cast<int>(cudaErrorInvalidValue)
                           : launch<uint8_t>(a, scratch_rows, st);
    case 2:
      return sat > 0xffffull ? static_cast<int>(cudaErrorInvalidValue)
                             : launch<uint16_t>(a, scratch_rows, st);
    case 4:
      return sat > 0xffffffffull ? static_cast<int>(cudaErrorInvalidValue)
                                 : launch<uint32_t>(a, scratch_rows, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
