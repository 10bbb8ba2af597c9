// The accumulate step's window, and the seed before it, in one launch:
// from the pool's alive flags and the center's flat position, the alive
// ranks, the window's bounds in rank space, the compaction of its
// candidates into `cand` in flat order, and the step's one read.
//
// What it computes is TorchDeviceAccumulator._window_ops and _seed
// (cluster/device_loop.py), their plain twin, bit for bit:
//   seed mode   the pool's first alive flat position leaves the pool and
//               opens cluster cid at stamp stepc, alone in the member list,
//               msum its row (zeros where another rank owns the row); it is
//               the window's center;
//   c0[p]       alive rows before flat position p (written into crank);
//   the bins    per side j (front 0, back 1) from the center's (blen, elen)
//               and start bins: a start bin without alive rows redirects to
//               the first (front) or last (back) non-empty bin at slot 0;
//               else the bvec's in-bin lower bound on (bin << 40) | min(len,
//               2^40 - 1), whose `high` starts at size - 1: an absent length
//               resolves to min(lower bound, size - 1), a present one to its
//               first (front) or last (back) occurrence; gf_j = the bin's
//               alive rank + slot;
//   the window  alive rows of rank in [gf0, gf1) with blen <= len <= elen,
//               compacted into cand[0, W) in flat order; with `extras` (a
//               row-sharded store) those whose rows lie in [row_lo, row_hi)
//               also into own_pos (their window positions) and own_rows
//               (row - row_lo);
//   the read    rd = (trip[0..2] or zeros, center, W, have, total[, own
//               count]), have = total > 0 && gf1 > gf0.
//
// Replaces the ~30 torch operations (~60 launches) that the host issued for
// a window and the ~10 of a seed.  It replaces no TPU kernel: the JAX
// package computes the same window inside its while loop's body
// (meshclust2_tpu/cluster/device_loop.py:_build_program.body, l. 1358-1405),
// one XLA program for the whole accumulate phase.
//
// What bounds it on an H100: it reads the n alive flags and writes the n + 1
// ranks (~0.9 MB at n = 100,000), reads the window's lengths, and writes W
// candidates: well under a microsecond of HBM time.  It is latency-bound,
// and what counts beside the one launch is the number of grid-wide barriers
// and of dependent round trips to memory.  The design:
//   - one cooperative launch (coop.cuh), a block a tile of 16 flat positions
//     a thread (4,096 a block), the tiles in flat order; three grid barriers:
//     (1) every block's alive count and first alive position, (2) the ranks
//     complete, (3) every block's count of candidates;
//   - a thread reads its 16 alive flags with one 16-byte load and keeps them
//     as bits; the seed (the first block's first alive position, in seed
//     mode) is taken out of the counts arithmetically, so no block waits for
//     its write;
//   - every block computes the window's scalars itself (no barrier for a
//     broadcast); the four in-bin searches of the center's start bins run
//     before barrier 2, one warp each, as 32-way searches (a handful of
//     rounds over 100,000 keys);
//   - a thread whose span of ranks misses [gf0, gf1) reads nothing more;
//     the others read their 16 lengths at once.
// The read buffer is written by block 0 after barrier 3; the host reads it
// with one copy.
//
// Built by nvcc for sm_90a (ops/_build.py) and bound through ctypes
// (ops/window_select.py): the entry point launches on the stream that its
// argument block names, allocates nothing, does not synchronise and returns
// the launch's error.

#include "coop.cuh"

namespace {

using namespace mc2;

constexpr int kChunk = 16;  // flat positions a thread reads with one load
constexpr long long kKeyMax = (1LL << 40) - 1;
constexpr int kParts = 4;   // per block: alive count, first alive, candidates, own

// Every field is 8 bytes wide, so the ctypes Structure of
// ops/window_select.py matches it without padding.
struct SelectArgs {
  const void* counts;  // store rows, uint8 or uint16
  long long d;
  long long size;      // bytes of one count
  long long n;         // flat positions
  long long nb;        // bins
  const long long* order;      // [n] flat position -> store row
  const long long* lens;       // [n]
  const long long* key;        // [n] (bin << 40) | len, sorted
  const long long* tab;        // [n, 4] blen, elen, front and back start bins
  const long long* bin_start;  // [nb + 1]
  long long* crank;            // [n + 1] out: alive rows before each position
  long long* cand;             // [n + 1] out: the window's flat positions
  unsigned char* alive;        // [n] state
  long long* assign;
  long long* astep;
  long long* members;
  long long* msum;             // [d]
  long long row_lo;            // the counts hold store rows [row_lo, row_hi)
  long long row_hi;
  long long extras;            // 1: own_pos, own_rows and their count
  long long* own_pos;          // [n + 1]
  long long* own_rows;         // [n + 1]
  long long* rd;               // [8] out: the read
  long long* part;             // [kParts kMaxGrid] per-block partials
  long long device;
  void* stream;
  // per call
  const long long* center;     // the center's flat position (scan mode)
  const long long* trip;       // the step's trip, or null for zeros
  long long seed;              // 1: seed mode
  long long cid;               // seed mode: the new cluster and stamp
  long long stepc;
};

// Alive flags i .. i + 15 (those below n) as bits.
__device__ __forceinline__ unsigned bits4(unsigned x) {
  return ((x & 0x01010101u) * 0x01020408u) >> 24;  // bytes 0/1 -> bits 0..3
}

__device__ __forceinline__ unsigned alive16(const unsigned char* alive, long long i, long long n) {
  if (i + kChunk <= n) {
    const uint4 v = *reinterpret_cast<const uint4*>(alive + i);
    return bits4(v.x) | bits4(v.y) << 4 | bits4(v.z) << 8 | bits4(v.w) << 12;
  }
  unsigned m = 0;
  for (int k = 0; i + k < n; ++k) m |= (alive[i + k] != 0 ? 1u : 0u) << k;
  return m;
}

// Exclusive prefix of x over the block's threads; *total gets the sum.
__device__ __forceinline__ long long block_scan(long long x, long long* buf, long long* total) {
  const int lane = threadIdx.x & (kWarpSize - 1);
  const int warp = threadIdx.x / kWarpSize;
  long long inc = x;
#pragma unroll
  for (int o = 1; o < kWarpSize; o <<= 1) {
    const long long y = __shfl_up_sync(kFullMask, inc, o);
    if (lane >= o) inc += y;
  }
  __syncthreads();  // buf may still be read from a previous call
  if (lane == kWarpSize - 1) buf[warp] = inc;
  __syncthreads();
  long long before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? buf[w] : 0;
    all += buf[w];
  }
  *total = all;
  return before + inc - x;
}

// The block's largest (MAX) or smallest x; every thread gets it.
template <bool MAX>
__device__ __forceinline__ long long block_ext(long long x, long long* buf) {
#pragma unroll
  for (int o = kWarpSize / 2; o > 0; o >>= 1) {
    const long long y = __shfl_xor_sync(kFullMask, x, o);
    x = MAX ? (y > x ? y : x) : (y < x ? y : x);
  }
  __syncthreads();
  if ((threadIdx.x & (kWarpSize - 1)) == 0) buf[threadIdx.x / kWarpSize] = x;
  __syncthreads();
  long long r = buf[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = MAX ? (buf[w] > r ? buf[w] : r) : (buf[w] < r ? buf[w] : r);
  return r;
}

// torch.searchsorted(a[0, n), v, right): the first i in [0, n] with a[i] > v
// (right) or a[i] >= v, by the warp: each round its lanes probe 32 evenly
// spaced points of [lo, hi), which holds the answer's neighbourhood.
__device__ long long warp_search(const long long* __restrict__ a, long long n, long long v,
                                 bool right) {
  const int lane = threadIdx.x & (kWarpSize - 1);
  long long lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const long long step = (hi - lo + kWarpSize - 1) / kWarpSize;
    const long long i = lo + lane * step;
    bool below = false;  // a[i] lies before the answer
    if (i < hi) {
      const long long x = __ldg(a + i);
      below = right ? x <= v : x < v;
    }
    const int c = __popc(__ballot_sync(kFullMask, below));  // lanes [0, c)
    if (c == 0) break;                                       // the answer is lo
    const long long next = lo + c * step;
    lo += (c - 1) * step + 1;
    if (next < hi) hi = next;
  }
  return lo;
}

// The window of the center over the span [lo, hi) of a thread whose first
// alive row has rank r: calls emit(position, is own) for each candidate.
template <typename F>
__device__ __forceinline__ void span_window(const SelectArgs& a, long long lo, long long hi,
                                            long long r, long long seed, long long gf0,
                                            long long gf1, long long t0, long long t1, F emit) {
  for (long long i = lo; i < hi && r < gf1; i += kChunk) {
    unsigned m = alive16(a.alive, i, a.n);
    if (seed >= i && seed < i + kChunk) m &= ~(1u << (seed - i));
    const int pc = __popc(m);
    if (r + pc <= gf0) {
      r += pc;
      continue;
    }
    long long len[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) len[k] = i + k < a.n ? __ldg(a.lens + i + k) : 0;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (!((m >> k) & 1u)) continue;
      if (r >= gf0 && r < gf1 && len[k] >= t0 && len[k] <= t1) {
        bool own = false;
        if (a.extras) {
          const long long row = __ldg(a.order + i + k);
          own = row >= a.row_lo && row < a.row_hi;
        }
        emit(i + k, own);
      }
      ++r;
    }
  }
}

__global__ void __launch_bounds__(kThreads) window_select_kernel(const SelectArgs a) {
  __shared__ long long buf[kWarps];
  __shared__ long long bounds_s[4];  // (lt, le) of the front's start bin, then the back's
  cg::grid_group grid = cg::this_grid();
  const long long n = a.n;
  const int G = gridDim.x;
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int warp = t / kWarpSize;
  // a thread's span: per positions, a multiple of kChunk
  const long long span = static_cast<long long>(G) * kThreads;
  const long long per = ((n + span - 1) / span + kChunk - 1) / kChunk * kChunk;
  const long long blo = static_cast<long long>(b) * kThreads * per;  // the block's [blo, bhi)
  const long long bhi = blo + kThreads * per;
  const long long lo = blo + t * per < n ? blo + t * per : n;
  const long long hi = lo + per < n ? lo + per : n;
  long long* part = a.part;
  long long* c0 = a.crank;

  // 1. each block's alive rows: their count and the first
  long long cnt = 0, first = n;
  for (long long i = lo; i < hi; i += kChunk) {
    const unsigned m = alive16(a.alive, i, n);
    if (m && first == n) first = i + __ffs(m) - 1;
    cnt += __popc(m);
  }
  {
    const long long bc = block_sum(cnt, buf);
    const long long bf = block_ext<false>(first, buf);
    if (t == 0) {
      part[b] = bc;
      part[kMaxGrid + b] = bf;
    }
  }
  grid.sync();

  // 2. the seed (the first alive position) and the ranks
  long long pre = 0, total = 0, seed = n;
  for (int g = t; g < G; g += kThreads) {
    const long long c = __ldcg(part + g);
    total += c;
    pre += g < b ? c : 0;
    if (a.seed) seed = min(seed, __ldcg(part + kMaxGrid + g));
  }
  total = block_sum(total, buf);
  pre = block_sum(pre, buf);
  if (a.seed) seed = block_ext<false>(seed, buf);
  if (!a.seed || seed >= n) seed = -1;  // scan mode, or no alive row
  if (seed >= 0) {
    --total;
    pre -= seed < blo ? 1 : 0;
    cnt -= seed >= lo && seed < hi ? 1 : 0;
  }
  long long bsum;
  const long long tp = pre + block_scan(cnt, buf, &bsum);  // alive ranks of the span from tp
  {
    long long r = tp;
    for (long long i = lo; i < hi; i += kChunk) {
      unsigned m = alive16(a.alive, i, n);
      if (seed >= i && seed < i + kChunk) m &= ~(1u << (seed - i));
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if (i + k < n) {
          r += (m >> k) & 1u;
          c0[i + k + 1] = r;
        }
      }
    }
  }
  if (b == 0 && t == 0) c0[0] = 0;
  if (seed >= lo && seed < hi) {
    a.alive[seed] = 0;
    a.assign[seed] = a.cid;
    a.astep[seed] = a.stepc;
    a.members[0] = seed;
  }
  if (seed >= blo && seed < bhi) {  // uniform: the seed's block writes msum
    const long long row = a.order[seed] - a.row_lo;
    const bool own = row >= 0 && row < a.row_hi - a.row_lo;
    for (long long e = t; e < a.d; e += kThreads) {
      long long v = 0;
      if (own) {
        v = a.size == 1 ? static_cast<const unsigned char*>(a.counts)[row * a.d + e]
                        : static_cast<const unsigned short*>(a.counts)[row * a.d + e];
      }
      a.msum[e] = v;
    }
  }
  const long long cur = a.seed ? seed : *a.center;
  if (cur >= 0 && warp < 4) {  // the in-bin searches of the start bins
    const int j = warp >> 1;
    const long long tgt = a.tab[4 * cur + j];
    const long long key = (a.tab[4 * cur + 2 + j] << 40) | (tgt < kKeyMax ? tgt : kKeyMax);
    const long long x = warp_search(a.key, n, key, warp & 1);
    if ((t & (kWarpSize - 1)) == 0) bounds_s[warp] = x;
  }
  grid.sync();  // the ranks complete (and bounds_s published)

  // 3. the window's bounds in rank space, then each block's candidates
  long long gf0 = 0, gf1 = 0, t0 = 0, t1 = -1;
  bool have = false;
  if (cur >= 0) {
    const long long* g = a.tab + 4 * cur;
    const long long* bs = a.bin_start;
    t0 = g[0];
    t1 = g[1];
    long long bq[2], rb[2], size[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      bq[j] = g[2 + j];
      rb[j] = __ldcg(c0 + bs[bq[j]]);
      size[j] = __ldcg(c0 + bs[bq[j] + 1]) - rb[j];
    }
    long long gf[2] = {0, 0};
    if (size[0] == 0 || size[1] == 0) {  // uniform: the first and last non-empty bins
      long long f = a.nb, l = -1;
      for (long long q = t; q < a.nb; q += kThreads) {
        if (f == a.nb && __ldcg(c0 + bs[q + 1]) >= 1) f = q;
        if (__ldcg(c0 + bs[q]) < total) l = q;
      }
      f = block_ext<false>(f, buf);
      l = block_ext<true>(l, buf);
      if (size[0] == 0) gf[0] = __ldcg(c0 + bs[f < a.nb - 1 ? f : a.nb - 1]);
      if (size[1] == 0) gf[1] = __ldcg(c0 + bs[l > 0 ? l : 0]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (size[j] == 0) continue;
      const long long at_lt = __ldcg(c0 + bounds_s[2 * j]);
      const long long lb = at_lt - rb[j];
      const long long eq = __ldcg(c0 + bounds_s[2 * j + 1]) - at_lt;
      const long long absent = lb < size[j] - 1 ? lb : size[j] - 1;
      gf[j] = rb[j] + (eq > 0 ? (j == 0 ? lb : lb + eq - 1) : absent);
    }
    gf0 = gf[0];
    gf1 = gf[1];
    have = total > 0 && gf1 > gf0;
  }
  long long mc = 0, oc = 0;
  if (have && tp < gf1 && tp + cnt > gf0) {
    span_window(a, lo, hi, tp, seed, gf0, gf1, t0, t1, [&](long long, bool own) {
      ++mc;
      oc += own;
    });
  }
  long long bm, bo;
  const long long mpre = block_scan(mc, buf, &bm);
  const long long opre = block_scan(oc, buf, &bo);
  if (t == 0) {
    part[2 * kMaxGrid + b] = bm;
    part[3 * kMaxGrid + b] = bo;
  }
  grid.sync();

  // 4. the compaction
  long long wpre = 0, W = 0, kpre = 0, K = 0;
  for (int g = t; g < G; g += kThreads) {
    const long long w = __ldcg(part + 2 * kMaxGrid + g);
    const long long k = __ldcg(part + 3 * kMaxGrid + g);
    W += w;
    K += k;
    wpre += g < b ? w : 0;
    kpre += g < b ? k : 0;
  }
  W = block_sum(W, buf);
  wpre = block_sum(wpre, buf);
  if (a.extras) {
    K = block_sum(K, buf);
    kpre = block_sum(kpre, buf);
  }
  if (mc > 0) {
    long long p = wpre + mpre, q = kpre + opre;
    span_window(a, lo, hi, tp, seed, gf0, gf1, t0, t1, [&](long long i, bool own) {
      a.cand[p] = i;
      if (own) {
        a.own_pos[q] = p;
        a.own_rows[q] = a.order[i] - a.row_lo;
        ++q;
      }
      ++p;
    });
  }
  if (b == 0 && t == 0) {
    long long* rd = a.rd;
#pragma unroll
    for (int k = 0; k < 3; ++k) rd[k] = a.trip ? a.trip[k] : 0;
    rd[3] = cur;
    rd[4] = W;
    rd[5] = have;
    rd[6] = total;
    if (a.extras) rd[7] = K;
  }
}

}  // namespace

extern "C" {

// int64 words of the per-block partials
long long mc2_window_select_part_len() { return kParts * kMaxGrid; }

// One window (seed = 0: of the center at *center, trip or null) or seed
// and window (seed = 1: cid and stepc the new cluster's) over the buffers
// of `fixed`, a SelectArgs; launches on fixed's stream and device.
int mc2_window_select(const void* fixed, const void* center, const void* trip, int seed,
                      long long cid, long long stepc) {
  SelectArgs a = *static_cast<const SelectArgs*>(fixed);
  a.center = static_cast<const long long*>(center);
  a.trip = static_cast<const long long*>(trip);
  a.seed = seed;
  a.cid = cid;
  a.stepc = stepc;
  if (a.n <= 0 || a.nb <= 0 || (!seed && !center) || (a.size != 1 && a.size != 2) ||
      reinterpret_cast<uintptr_t>(a.alive) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int was = 0;
  cudaError_t e = cudaGetDevice(&was);
  if (e == cudaSuccess && was != a.device) e = cudaSetDevice(static_cast<int>(a.device));
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&a};
  const long long want = (a.n + static_cast<long long>(kThreads) * kChunk - 1) /
                         (static_cast<long long>(kThreads) * kChunk);
  e = coop_launch(reinterpret_cast<const void*>(&window_select_kernel), want, 0, args,
                  static_cast<cudaStream_t>(a.stream));
  if (e == cudaSuccess) e = cudaGetLastError();
  if (was != a.device) cudaSetDevice(was);
  return static_cast<int>(e);
}

}  // extern "C"
