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
// 6.6 us at the 10k bench set (22 MB at 3.35 TB/s).  The design splits the
// work by windows, not by records:
//   - a warp is one work item, a piece of at most `piece` positions of one
//     record (the wrapper picks `piece`, >= 8,192).  Record r owns the
//     items [base(r), base(r + 1)) with base(r) = r + offsets[r] / piece,
//     enough for its pieces; a warp finds its record by a 32-ary search
//     over base (one load a lane a round, three rounds at 10k) and idles
//     when its record has fewer pieces.  Short records are several to a
//     block, a warp each; a long record spreads over the SMs.  No block
//     or grid barrier: warps only meet at __syncwarp;
//   - a warp sweeps its positions in rounds of 512: each lane loads its
//     aligned 16 codes with one 16-byte load (the next round's in flight),
//     takes the k - 1 codes after them from its neighbour by shuffles, and
//     rolls its window index over its 16 positions, one byte a window.
//     Segment bounds and the piece's bounds mask windows and 1-mers, so a
//     window across a segment boundary never counts.  Equal indices of
//     consecutive windows are added as one run (a homopolymer adds once a
//     lane a round);
//   - k <= 7: each warp keeps a private histogram of 16-bit counters
//     (pairs in 32-bit words, added by 32-bit shared atomics; a piece has
//     <= 65,535 windows) and writes its record's row itself: the
//     saturation min(1 + count, sat), 16 counts a lane a store (16, 32 or
//     64 bytes), neighbouring lanes on neighbouring addresses;
//   - k >= 8 (4^k bins no longer fit): a record in one piece writes its
//     row of ones with wide stores, then adds each run of windows into the
//     row in place: an atomic add to the count's 32-bit word where the
//     piece's windows cannot reach the saturation, else a compare-and-swap
//     that saturates;
//   - a record in several pieces adds each piece's counts into a uint32
//     accumulator row (global atomics, nonzero bins only), and the warp
//     that arrives last (an arrival counter a row) writes the saturated
//     row and the 1-mers, and zeroes the accumulator and its counter: the
//     scratch is zero before and after every launch.
//
// Built by nvcc for sm_90a (ops/_build.py) and bound through ctypes: the
// entry point launches on the given stream, allocates nothing, does not
// synchronise and returns the launch's error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpSize = 32;
constexpr int kWarps = 8;          // warps a block, fewer where histograms are large
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kRun = 16;           // positions a lane a round
constexpr int kRound = kRun * kWarpSize;
// the largest k whose histograms the warps keep in shared memory (the
// wrapper's SHARED_K); above it the global instantiation
constexpr int kSharedK = 7;
// the shared memory a block may hold
constexpr int kMaxShared = 7 * 32768;

struct CountArgs {
  const signed char* codes;
  const signed char* codes_end;  // one past the codes' last byte
  const long long* offsets;      // [n + 1] into codes
  const long long* segs;         // [2 G]: (start, end inclusive) per segment
  const long long* seg_offsets;  // [n + 1] into the segments
  long long n;
  long long piece;               // positions a work item
  long long items;
  int k;
  unsigned long long sat;
  void* counts;                  // [n, 4^k] at the natural width
  long long* ones;               // [n, 4]
  unsigned* acc;                 // [rows, 4^k]: split records' counts, zero
  unsigned long long* acc_ones;  // [rows, 4]
  int* arrive;                   // [rows]
};

__device__ __forceinline__ long long item_base(const CountArgs& a, long long r) {
  return r + a.offsets[r] / a.piece;
}

// the record whose items hold v: the largest r with base(r) <= v (base is
// strictly increasing, base(0) = 0), by rounds of 32 probes
__device__ long long find_record(const CountArgs& a, long long v, int lane) {
  long long lo = 0, hi = a.n;
  while (hi - lo > 1) {
    const long long step = (hi - lo + kWarpSize - 1) / kWarpSize;
    const long long r = lo + step * (lane + 1);
    const bool ok = r < hi && item_base(a, r) <= v;
    const long long c = __popc(__ballot_sync(kFullMask, ok));
    hi = min(hi, lo + step * (c + 1));
    lo += step * c;
  }
  return lo;
}

__device__ __forceinline__ uint4 load16(const signed char* p, const signed char* end) {
  if (p >= end) return make_uint4(0, 0, 0, 0);
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Sweep positions [lo, hi) of seq: the 1-mers of every position, and every
// window starting in [lo, whi) (whi <= hi), whose k codes the caller
// guarantees lie inside one segment.  add(x, run) adds run windows of
// index x; b[] counts the bases (this lane's share).  K is k where it is a
// compile-time constant (the slots past a window's reach then drop out),
// else 0.
template <int K, typename Add>
__device__ void sweep(const CountArgs& a, const signed char* seq, long long lo, long long whi,
                      long long hi, int lane, Add& add, unsigned (&b)[4]) {
  if (lo >= hi) return;
  const int k = K ? K : a.k;
  const unsigned mask = (1u << (2 * k)) - 1u;
  const signed char* first =
      reinterpret_cast<const signed char*>(reinterpret_cast<uintptr_t>(seq + lo) & ~uintptr_t(15));
  const signed char* stop = seq + hi;
  uint4 cur = load16(first + kRun * lane, a.codes_end);
  uint4 nxt = lane == kWarpSize - 1 ? load16(first + kRound, a.codes_end) : make_uint4(0, 0, 0, 0);
  for (const signed char* rb = first; rb < stop; rb += kRound) {
    // the next round's codes in flight while this one is counted
    const signed char* end = rb + kRound < stop ? a.codes_end : rb;
    const uint4 cur2 = load16(rb + kRound + kRun * lane, end);
    const uint4 nxt2 = lane == kWarpSize - 1 ? load16(rb + 2 * kRound, end)
                                             : make_uint4(0, 0, 0, 0);
    uint4 h;
    h.x = __shfl_down_sync(kFullMask, cur.x, 1);
    h.y = __shfl_down_sync(kFullMask, cur.y, 1);
    h.z = __shfl_down_sync(kFullMask, cur.z, 1);
    h.w = __shfl_down_sync(kFullMask, cur.w, 1);
    if (lane == kWarpSize - 1) h = nxt;
    const unsigned w[8] = {cur.x, cur.y, cur.z, cur.w, h.x, h.y, h.z, h.w};
    // this lane's positions p0 .. p0 + 15, relative to seq, and the slots
    // of them that count as 1-mers and as window starts
    const long long p0 = (rb + kRun * lane) - seq;
    const int o_lo = static_cast<int>(max(0LL, min(16LL, lo - p0)));
    const int o_hi = static_cast<int>(max(0LL, min(16LL, hi - p0)));
    const int w_hi = static_cast<int>(max(0LL, min(16LL, whi - p0)));
    unsigned x = 0, prev = 0, run = 0;
    auto window = [&](unsigned xi) {
      if (run != 0 && xi == prev) {
        ++run;
      } else {
        if (run != 0) add(prev, run);
        prev = xi;
        run = 1;
      }
    };
    unsigned packed = 0;
#pragma unroll
    for (int i = 0; i < kRun + 14; ++i) {
      const unsigned c = (w[i >> 2] >> ((i & 3) * 8)) & 3u;
      x = ((x << 2) | c) & mask;
      if (i < kRun && i >= o_lo && i < o_hi) packed += 1u << (c * 8);
      const int s = i - (k - 1);
      if (s >= 0 && s < kRun && s >= o_lo && s < w_hi) window(x);
    }
    b[0] += packed & 0xffu;
    b[1] += (packed >> 8) & 0xffu;
    b[2] += (packed >> 16) & 0xffu;
    b[3] += packed >> 24;
    if (run != 0) add(prev, run);
    cur = cur2;
    nxt = nxt2;
  }
}

// every segment's part of the piece [pa, pb) of record r
template <int K, typename Add>
__device__ void sweep_piece(const CountArgs& a, long long r, long long pa, long long pb, int lane,
                            Add& add, unsigned (&b)[4]) {
  const signed char* seq = a.codes + a.offsets[r];
  const long long g1 = a.seg_offsets[r + 1];
  for (long long g = a.seg_offsets[r]; g < g1; ++g) {
    const long long s = a.segs[2 * g];
    const long long e = a.segs[2 * g + 1];
    const long long lo = max(s, pa);
    const long long hi = min(e + 1, pb);
    const long long whi = min(e - a.k + 2, pb);
    sweep<K>(a, seq, lo, max(lo, whi), hi, lane, add, b);
  }
}

__device__ __forceinline__ unsigned long long saturate(unsigned long long v, unsigned long long sat) {
  return v < sat ? v : sat;
}

// 16 counts (1 + h[j], saturated) at the natural width, as 16-byte stores
template <typename T>
__device__ __forceinline__ void store16(T* dst, const unsigned (&h)[16], unsigned long long sat) {
  if (sizeof(T) == 1) {
    unsigned w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      w[q] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[q] |= static_cast<unsigned>(saturate(h[4 * q + j] + 1ull, sat)) << (8 * j);
    }
    reinterpret_cast<uint4*>(dst)[0] = make_uint4(w[0], w[1], w[2], w[3]);
  } else if (sizeof(T) == 2) {
    unsigned w[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      w[q] = static_cast<unsigned>(saturate(h[2 * q] + 1ull, sat)) |
             (static_cast<unsigned>(saturate(h[2 * q + 1] + 1ull, sat)) << 16);
    reinterpret_cast<uint4*>(dst)[0] = make_uint4(w[0], w[1], w[2], w[3]);
    reinterpret_cast<uint4*>(dst)[1] = make_uint4(w[4], w[5], w[6], w[7]);
  } else {
    unsigned w[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) w[q] = static_cast<unsigned>(saturate(h[q] + 1ull, sat));
#pragma unroll
    for (int q = 0; q < 4; ++q)
      reinterpret_cast<uint4*>(dst)[q] = make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
  }
}

// the row out[0 .. D) = min(1 + get(x), sat) by the warp; get16(x0, h)
// fills the 16 counts from x0 (D >= 16), get(x) one
template <typename T, typename Get16, typename Get>
__device__ void write_row(T* out, long long D, unsigned long long sat, int lane, Get16& get16,
                          Get& get) {
  if (D >= 16) {
    for (long long x0 = 16LL * lane; x0 < D; x0 += 16LL * kWarpSize) {
      unsigned h[16];
      get16(x0, h);
      store16<T>(out + x0, h, sat);
    }
  } else {
    for (long long x = lane; x < D; x += kWarpSize)
      out[x] = static_cast<T>(saturate(get(x) + 1ull, sat));
  }
}

__device__ __forceinline__ void warp_sum4(unsigned (&b)[4]) {
#pragma unroll
  for (int o = kWarpSize / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] += __shfl_xor_sync(kFullMask, b[j], o);
  }
}

// A record split over several items: add this piece's 1-mers, then arrive;
// the last to arrive writes the row from the accumulator and zeroes it.
template <typename T>
__device__ void arrive_and_finish(const CountArgs& a, long long r, long long row, long long m,
                                  int lane, const unsigned (&b)[4]) {
  const long long D = 1LL << (2 * a.k);
  if (lane < 4) atomicAdd(&a.acc_ones[4 * row + lane], static_cast<unsigned long long>(b[lane]));
  __threadfence();
  __syncwarp();
  int old = 0;
  if (lane == 0) old = atomicAdd(&a.arrive[row], 1);
  old = __shfl_sync(kFullMask, old, 0);
  if (old != m - 1) return;
  __threadfence();
  unsigned* acc = a.acc + row * D;
  auto get16 = [&](long long x0, unsigned (&h)[16]) {
    uint4* p = reinterpret_cast<uint4*>(acc + x0);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = __ldcg(p + q);
      h[4 * q] = v.x;
      h[4 * q + 1] = v.y;
      h[4 * q + 2] = v.z;
      h[4 * q + 3] = v.w;
      __stcg(p + q, make_uint4(0, 0, 0, 0));
    }
  };
  auto get = [&](long long x) {
    const unsigned v = __ldcg(acc + x);
    __stcg(acc + x, 0u);
    return v;
  };
  write_row<T>(static_cast<T*>(a.counts) + r * D, D, a.sat, lane, get16, get);
  if (lane < 4) {
    a.ones[4 * r + lane] = static_cast<long long>(__ldcg(&a.acc_ones[4 * row + lane])) + 1;
    __stcg(&a.acc_ones[4 * row + lane], 0ull);
  }
  if (lane == 0) a.arrive[row] = 0;
}

// k = K <= kSharedK: a private histogram of 16-bit counters a warp
template <typename T, int K>
__global__ void __launch_bounds__(kWarps * kWarpSize) kmer_shared_kernel(const CountArgs a) {
  extern __shared__ __align__(16) unsigned smem[];
  const int lane = threadIdx.x & (kWarpSize - 1);
  const int warp = threadIdx.x / kWarpSize;
  const long long v = static_cast<long long>(blockIdx.x) * (blockDim.x / kWarpSize) + warp;
  if (v >= a.items) return;
  const long long r = find_record(a, v, lane);
  const long long len = a.offsets[r + 1] - a.offsets[r];
  const long long m = len > a.piece ? (len + a.piece - 1) / a.piece : 1;
  const long long j = v - item_base(a, r);
  if (j >= m) return;
  const long long D = 1LL << (2 * a.k);
  const int words = static_cast<int>(D > 2 ? D / 2 : 2);
  unsigned* hist = smem + static_cast<long long>(warp) * ((words + 3) & ~3);
  if (words >= 4) {
    for (int q = 4 * lane; q < words; q += 4 * kWarpSize)
      *reinterpret_cast<uint4*>(hist + q) = make_uint4(0, 0, 0, 0);
  } else if (lane < words) {
    hist[lane] = 0;
  }
  __syncwarp();
  auto add = [&](unsigned x, unsigned run) { atomicAdd(&hist[x >> 1], run << ((x & 1u) << 4)); };
  unsigned b[4] = {0, 0, 0, 0};
  sweep_piece<K>(a, r, j * a.piece, min(len, (j + 1) * a.piece), lane, add, b);
  warp_sum4(b);
  __syncwarp();
  if (m == 1) {
    auto get16 = [&](long long x0, unsigned (&h)[16]) {
      const uint4* p = reinterpret_cast<const uint4*>(hist + x0 / 2);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uint4 v4 = p[q];
        const unsigned w4[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          h[8 * q + 2 * t] = w4[t] & 0xffffu;
          h[8 * q + 2 * t + 1] = w4[t] >> 16;
        }
      }
    };
    auto get = [&](long long x) { return (hist[x >> 1] >> ((x & 1) << 4)) & 0xffffu; };
    write_row<T>(static_cast<T*>(a.counts) + r * D, D, a.sat, lane, get16, get);
    if (lane < 4) a.ones[4 * r + lane] = static_cast<long long>(b[lane]) + 1;
    return;
  }
  const long long row = a.offsets[r] / a.piece;
  unsigned* acc = a.acc + row * D;
  for (long long x = lane; x < D; x += kWarpSize) {
    const unsigned c = (hist[x >> 1] >> ((x & 1) << 4)) & 0xffffu;
    if (c != 0) atomicAdd(&acc[x], c);
  }
  arrive_and_finish<T>(a, r, row, m, lane, b);
}

// add run to the count at x of a row at width T, in place: one atomic add
// to its 32-bit word where the count cannot reach sat (`exact`), else a
// compare-and-swap that saturates
template <typename T>
__device__ __forceinline__ void add_in_place(T* row, unsigned x, unsigned run,
                                             unsigned long long sat, bool exact) {
  constexpr int per = 4 / sizeof(T);
  constexpr unsigned field = sizeof(T) == 4 ? 0xffffffffu : (1u << (8 * (sizeof(T) % 4))) - 1u;
  unsigned* word = reinterpret_cast<unsigned*>(row) + x / per;
  const int shift = static_cast<int>(x % per) * 8 * static_cast<int>(sizeof(T));
  if (exact) {
    atomicAdd(word, run << shift);
    return;
  }
  const unsigned fmask = field << shift;
  unsigned old = __ldcg(word);
  while (true) {
    const unsigned long long f = (old & fmask) >> shift;
    const unsigned long long nf = saturate(f + run, sat);
    const unsigned nw = (old & ~fmask) | (static_cast<unsigned>(nf) << shift);
    const unsigned seen = atomicCAS(word, old, nw);
    if (seen == old) break;
    old = seen;
  }
}

// k > kSharedK: no shared histograms
template <typename T>
__global__ void __launch_bounds__(kWarps * kWarpSize) kmer_global_kernel(const CountArgs a) {
  const int lane = threadIdx.x & (kWarpSize - 1);
  const int warp = threadIdx.x / kWarpSize;
  const long long v = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (v >= a.items) return;
  const long long r = find_record(a, v, lane);
  const long long len = a.offsets[r + 1] - a.offsets[r];
  const long long m = len > a.piece ? (len + a.piece - 1) / a.piece : 1;
  const long long j = v - item_base(a, r);
  if (j >= m) return;
  const long long D = 1LL << (2 * a.k);
  unsigned b[4] = {0, 0, 0, 0};
  if (m == 1) {
    T* out = static_cast<T*>(a.counts) + r * D;
    auto zero16 = [](long long, unsigned (&h)[16]) {
#pragma unroll
      for (int q = 0; q < 16; ++q) h[q] = 0;
    };
    auto zero = [](long long) { return 0u; };
    write_row<T>(out, D, a.sat, lane, zero16, zero);
    __threadfence();
    __syncwarp();
    // a record in one piece has at most `piece` windows in a bin
    const bool exact = static_cast<unsigned long long>(a.piece) < a.sat;
    auto add = [&](unsigned x, unsigned run) { add_in_place<T>(out, x, run, a.sat, exact); };
    sweep_piece<0>(a, r, 0, len, lane, add, b);
    warp_sum4(b);
    if (lane < 4) a.ones[4 * r + lane] = static_cast<long long>(b[lane]) + 1;
    return;
  }
  const long long row = a.offsets[r] / a.piece;
  unsigned* acc = a.acc + row * D;
  auto add = [&](unsigned x, unsigned run) { atomicAdd(&acc[x], run); };
  sweep_piece<0>(a, r, j * a.piece, min(len, (j + 1) * a.piece), lane, add, b);
  warp_sum4(b);
  arrive_and_finish<T>(a, r, row, m, lane, b);
}

int warps_for(int k) {
  const long long bytes = ((((1LL << (2 * k)) / 2 > 2 ? (1LL << (2 * k)) / 2 : 2) + 3) & ~3LL) * 4;
  const long long w = kMaxShared / bytes;
  return static_cast<int>(w < kWarps ? w : kWarps);
}

template <typename T, int K>
int launch_shared(const CountArgs& a, cudaStream_t stream) {
  const int wpb = warps_for(K);
  const long long D = 1LL << (2 * K);
  const long long words = ((D / 2 > 2 ? D / 2 : 2) + 3) & ~3LL;
  const size_t shm = static_cast<size_t>(wpb * words * 4);
  auto kernel = &kmer_shared_kernel<T, K>;
  if (shm > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shm));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long grid = (a.items + wpb - 1) / wpb;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<dim3(static_cast<unsigned>(grid)), dim3(wpb * kWarpSize), shm, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const CountArgs& a, cudaStream_t stream) {
  switch (a.k) {
    case 1: return launch_shared<T, 1>(a, stream);
    case 2: return launch_shared<T, 2>(a, stream);
    case 3: return launch_shared<T, 3>(a, stream);
    case 4: return launch_shared<T, 4>(a, stream);
    case 5: return launch_shared<T, 5>(a, stream);
    case 6: return launch_shared<T, 6>(a, stream);
    case 7: return launch_shared<T, 7>(a, stream);
    default: break;
  }
  static_assert(kSharedK == 7, "launch dispatches k = 1..7 to the shared kernel");
  const long long grid = (a.items + kWarps - 1) / kWarps;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kmer_global_kernel<T><<<dim3(static_cast<unsigned>(grid)), dim3(kWarps * kWarpSize), 0,
                          stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// codes int8 [n_codes] (values 0..3 inside the segments); offsets,
// seg_offsets int64 [n + 1]; segs int64 [2 G]; piece >= 1 the positions of
// a work item (<= 65,535 for k <= kSharedK, 7); width 1, 2 or 4
// bytes (the counts' natural width); counts [n, 4^k] at that width, 16-byte
// aligned; ones int64 [n, 4]; scratch, zero, for rows = n_codes / piece + 1
// split records (none when piece > n_codes: may be null): acc_ones uint64
// [rows, 4], acc uint32 [rows, 4^k], arrive int32 [rows], left zero.
// 1 <= k <= 15, 1 <= sat <= the width's max.
int mc2_kmer_count(const void* codes, long long n_codes, const void* offsets, const void* segs,
                   const void* seg_offsets, long long n, long long piece, int k,
                   unsigned long long sat, int width, void* counts, void* ones, void* acc_ones,
                   void* acc, void* arrive, void* stream) {
  if (n < 0 || n_codes < 0 || piece < 1 || k < 1 || k > 15 || sat < 1 ||
      (k <= kSharedK && piece > 65535) ||
      (reinterpret_cast<uintptr_t>(counts) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  if (piece <= n_codes && (acc == nullptr || acc_ones == nullptr || arrive == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const CountArgs a{static_cast<const signed char*>(codes),
                    static_cast<const signed char*>(codes) + n_codes,
                    static_cast<const long long*>(offsets),
                    static_cast<const long long*>(segs),
                    static_cast<const long long*>(seg_offsets),
                    n,
                    piece,
                    n + n_codes / piece,
                    k,
                    sat,
                    counts,
                    static_cast<long long*>(ones),
                    static_cast<unsigned*>(acc),
                    static_cast<unsigned long long*>(acc_ones),
                    static_cast<int*>(arrive)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 1:
      return sat > 0xffull ? static_cast<int>(cudaErrorInvalidValue) : launch<uint8_t>(a, st);
    case 2:
      return sat > 0xffffull ? static_cast<int>(cudaErrorInvalidValue) : launch<uint16_t>(a, st);
    case 4:
      return sat > 0xffffffffull ? static_cast<int>(cudaErrorInvalidValue)
                                 : launch<uint32_t>(a, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
