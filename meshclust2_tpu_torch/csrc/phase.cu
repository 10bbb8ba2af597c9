// The update phase's per-iteration layout and its merge replay, over state
// that stays on the card for the whole phase.
//
// The state: per row its cluster slot assign[r] and its position seq[r] in
// that cluster's member list; per slot s the center row cen[s], alive[s]
// and the member count clen[s].  Slots are the clusters at the phase's
// start, in the engine's order; a merge kills a slot and never makes one,
// so the alive slots in ascending order are the engine's cluster list.
//
// phase_layout (mc2_phase_layout), one cooperative launch of 1,024-thread
// blocks with one grid barrier:
//   1. every block ranks the slots itself, in its shared memory (int32, 16
//      bytes a slot): one scan over the slots (block_scan: neighbouring
//      threads on neighbouring slots, 4,096 slots a pass, four loads in
//      flight a thread), of (alive, clen) packed as alive << 32 | clen,
//      whose prefix is rank << 32 | member offset, gives rank[s], inv[rank]
//      = s and moff[rank] (moff[C] = n); a second scan over the C ranks
//      gives ipre[j], the first position of center rank j's neighbourhood
//      in the flat sequence of all (center, member) positions: j's slice
//      flat[moff[j - delta] .. moff[j + delta + 1]) (ranks clamped to
//      [0, C)), ipre[C] = W <= (2 delta + 1) n.  Each block writes its
//      share of rank, inv and moff;
//   2. the flat member table flat[moff[rank[assign[r]]] + seq[r]] = r (a
//      scatter: every row lands at its cluster's offset plus its position,
//      so cluster k's members are flat[moff[k] .. moff[k + 1]) in order);
//      the grid barrier;
//   3. the pairs in one sweep over the W positions, in tiles of 1,024
//      positions, one a thread (of 4,096, four a thread, where the small
//      tiles outnumber the blocks that fit at once): a tile stages in
//      shared memory the member rows and lengths of the slice of flat
//      between the least and the largest member position it touches (~200
//      entries at the 10k shapes; past 2,048, next to a cluster of
//      thousands, it reads them from global memory) and its centers' rows
//      and length windows (up to 1,024), so a member row is read once a
//      tile and not once a center; each thread finds its center rank j by
//      binary search in ipre and keeps the member r when lens[r] lies in
//      [blen[c], elen[c]] of the center row c; the tile's count reaches the
//      next tiles by a single-pass chained scan (decoupled look-back over
//      descriptors in scratch), and the kept pairs are written in gather
//      order as (a_rows = c, b_rows = r, seg = j), P in all.  hdr = (C, P).
// A state whose slots do not fit in shared memory beside the tile's 45 KB
// (~11,700 slots on an H100) takes the wide instantiation: block 0 ranks
// into the outputs and scratch, a second grid barrier, the same scatter
// and sweep.
// The gather order is the host engine's (cluster/engine.py:
// _batched_mean_shift_update) and the tie order (2 delta - o, seq) of the
// JAX program's closest-to-mean key (meshclust2_tpu/cluster/
// device_phase.py l. 374-375), so closest_mean's first minimum by position
// is the reference's tie rule.
//
// The new centers and the merge candidates of an iteration are computed
// after its filter, inside the launch of csrc/closest_mean.cu's phase
// instantiation (mc2_closest_candidates), from these kernels' Layout.
//
// merge_replay (mc2_merge_replay): the merge pass's absorb events t_dst[s]
// (the slot s merges into, or -1), applied in ascending slot order as the
// host engine applies them (`clusters[ret].members.extend(clusters[i].
// members)`): the members of s get seq += clen[dst] and assign = dst,
// clen[dst] += clen[s], s dies.  Every destination lies above its source,
// so a slot's whole inflow comes before its own event, and the events form
// a forest whose roots are the slots that survive.  Every block solves the
// slots itself in its shared memory (int32, 20 bytes a slot):
//   - the event list, by a block scan over the slots (coalesced), and each
//     destination's count of sources;
//   - each event's size when it comes (clen plus its sources' sizes), in
//     rounds of the events whose sources are all applied: as many rounds
//     as the longest chain, each a pass of the block over the events;
//   - each event's offset, its destination's size before it (clen[d] plus
//     the sizes of d's lower sources): every warp sums, for its chunks of
//     32 events, each event's lower siblings in the chunk (grouped by
//     __match_any_sync), then one warp walks the chunks in order, a read
//     and a write of the destination's running size a step;
//   - each slot's final slot and the total offset of its members, a path
//     sum over the forest (fin[s] = fin[d], tot[s] = off[s] + tot[d]), by
//     pointer jumping: ceil(log2 depth) + 1 rounds of the block;
// then moves its own share of the rows (assign = fin, seq += tot): no grid
// barrier and no scratch.  Past the shared-memory limit (~11,600 slots on
// an H100) the wide instantiation: block 0 solves the slots in int32
// scratch, one grid barrier (a cooperative launch), every block moves rows.
//
// Replaces the JAX program meshclust2_tpu/cluster/device_phase.py:
// DevicePhaseUpdater._build's `ranks` (l. 218-226) and the row targeting
// of `filter_mean`, `closest` and `merge_pass.q_body` (l. 261-282, 326-352,
// 462-470) (phase_layout), and `rp_body` (l. 519-547, a while-loop over
// absorb events with an O(rows) masked update each) (merge_replay); the
// port's host-driven counterpart built the same pairs in numpy each
// iteration (cluster/engine.py).
//
// What bounds them on an H100: at the 10k bench set's shapes (n = 10,000
// rows, C ~ 800-1,150 clusters, P ~ 90,000-110,000 pairs) they move under
// 3 MB a call, about a microsecond of the card's memory rate; they are
// latency-bound: the launch (~5 us by events, an empty kernel's), the
// grid barrier (~2 us), a block's barriers (three a pass of its scans),
// dependent global loads (the rows', the staging's), the tiles' look-back,
// and in the replay the rounds (the longest chain's, the pointer
// jumping's) and the warp's E / 32 dependent steps.
//
// Built by nvcc for sm_90a (ops/_build.py) and bound through ctypes: the
// entry points launch on the given stream, allocate nothing, do not
// synchronise and return the launch's error.

#include <algorithm>
#include <mutex>

#include "coop.cuh"

namespace {

using namespace mc2;

// the layout's and the replay's blocks
constexpr int kBig = 1024;
constexpr int kBigWarps = kBig / kWarpSize;  // 32: a block's warp counts fill one warp
// the layout's tile: pair positions a tile, K a thread (thread t takes
// positions t, t + kBig, ...; K = 1, or 4 where the 1,024-position tiles
// outnumber the blocks that fit), and the most member rows and centers a
// tile stages in shared memory
constexpr long long kTile = kBig;  // at K = 1: the most tiles
constexpr long long kStageRows = 2048;
constexpr long long kStageCenters = 1024;
// a look-back descriptor: the flag in the top two bits, the count below
constexpr unsigned long long kAggregate = 1ull << 62;  // the tile's own count
constexpr unsigned long long kInclusive = 2ull << 62;  // the count of the tiles up to it
constexpr unsigned long long kCount = (1ull << 62) - 1;
constexpr long long kLow32 = 0xffffffffLL;

// Exclusive prefix sums of val(i) over [0, m) by the whole block:
// sink(i, sum of val over [0, i), val(i)) for every i; returns the total to
// every thread.  A pass takes kScanRows rows of blockDim items, thread t
// item t of each row, so a warp reads 32 neighbouring elements and a
// thread has kScanRows loads in flight; the rows are scanned side by side
// (three block barriers a pass).  val(i) runs before sink(i), in the same
// thread.  buf holds kScanRows * kWarpSize values.  Every thread of the
// block calls it; for m > 0 it ends with a block barrier.
constexpr int kScanRows = 4;

template <class Val, class Sink>
__device__ long long block_scan(long long m, Val val, Sink sink, long long* buf) {
  const int lane = threadIdx.x & (kWarpSize - 1);
  const int warp = threadIdx.x / kWarpSize;
  const int nw = blockDim.x / kWarpSize;
  long long carry = 0;
  for (long long base = 0; base < m; base += static_cast<long long>(kScanRows) * blockDim.x) {
    long long v[kScanRows], x[kScanRows];
#pragma unroll
    for (int k = 0; k < kScanRows; ++k) {
      const long long i = base + static_cast<long long>(k) * blockDim.x + threadIdx.x;
      v[k] = i < m ? static_cast<long long>(val(i)) : 0LL;
      x[k] = v[k];
    }
#pragma unroll
    for (int o = 1; o < kWarpSize; o <<= 1) {  // inclusive scans over the warp
#pragma unroll
      for (int k = 0; k < kScanRows; ++k) {
        const long long y = __shfl_up_sync(kFullMask, x[k], o);
        if (lane >= o) x[k] += y;
      }
    }
    if (lane == kWarpSize - 1) {
#pragma unroll
      for (int k = 0; k < kScanRows; ++k) buf[k * kWarpSize + warp] = x[k];
    }
    __syncthreads();
    if (warp == 0) {  // the warp totals, row by row: inclusive, rows before included
      long long w[kScanRows];
#pragma unroll
      for (int k = 0; k < kScanRows; ++k) w[k] = lane < nw ? buf[k * kWarpSize + lane] : 0LL;
#pragma unroll
      for (int o = 1; o < kWarpSize; o <<= 1) {
#pragma unroll
        for (int k = 0; k < kScanRows; ++k) {
          const long long y = __shfl_up_sync(kFullMask, w[k], o);
          if (lane >= o) w[k] += y;
        }
      }
      long long run = 0;
#pragma unroll
      for (int k = 0; k < kScanRows; ++k) {
        const long long row = __shfl_sync(kFullMask, w[k], kWarpSize - 1);
        buf[k * kWarpSize + lane] = run + w[k];
        run += row;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kScanRows; ++k) {
      const long long i = base + static_cast<long long>(k) * blockDim.x + threadIdx.x;
      // everything before this warp's part of row k
      const long long before = warp ? buf[k * kWarpSize + warp - 1]
                                    : (k ? buf[(k - 1) * kWarpSize + kWarpSize - 1] : 0LL);
      if (i < m) sink(i, carry + before + x[k] - v[k], v[k]);
    }
    carry += buf[(kScanRows - 1) * kWarpSize + kWarpSize - 1];
    __syncthreads();  // buf is rewritten by the next pass
  }
  return carry;
}

// -- the layout ----------------------------------------------------------------

struct LayoutArgs {
  long long n, S;
  int delta;
  const long long* assign;
  const long long* seq;
  const unsigned char* alive;
  const long long* cen;
  const long long* clen;
  const long long* lens;
  const long long* blen;
  const long long* elen;
  long long* rank;
  long long* inv;
  long long* moff;   // [S + 1]
  long long* flat;   // [n]
  long long* a_rows;  // [(2 delta + 1) n]
  long long* b_rows;
  long long* seg;
  long long* ipre;            // scratch [S + 1]: the wide instantiation's ipre
  unsigned long long* desc;   // scratch [tiles]: the tiles' look-back descriptors
  long long* hdr;             // [2]: C, P
};

// Step 1 by the calling block into arrays of type I (its shared memory, or
// the wide instantiation's outputs and scratch): inv, moff and ipre by
// rank, soff[s] (when given) each slot's member offset, and rank[s] into
// the output for s in [rlo, rhi).  C and W to every thread.
template <class I>
__device__ void rank_slots(const LayoutArgs& a, I* soff, I* inv, I* moff, I* ipre,
                           long long rlo, long long rhi, long long* buf, long long& C,
                           long long& W) {
  const unsigned char* alive = a.alive;
  const long long* clen = a.clen;
  long long* rank = a.rank;
  const long long d = a.delta;
  const long long tot = block_scan(
      a.S,
      [&](long long s) {
        const long long c = clen[s];  // both loads at once
        return alive[s] ? (1LL << 32) | c : 0LL;
      },
      [&](long long s, long long ex, long long v) {
        const long long r = ex >> 32, o = ex & kLow32;
        if (soff) soff[s] = static_cast<I>(o);
        if (v) {
          inv[r] = static_cast<I>(s);
          moff[r] = static_cast<I>(o);
        }
        if (s >= rlo && s < rhi) rank[s] = r;
      },
      buf);
  C = tot >> 32;
  if (threadIdx.x == 0) moff[C] = static_cast<I>(tot & kLow32);
  __syncthreads();
  W = block_scan(
      C,
      [&](long long j) {
        return static_cast<long long>(moff[min(C - 1, j + d) + 1]) -
               static_cast<long long>(moff[max(0LL, j - d)]);
      },
      [&](long long j, long long ex, long long) { ipre[j] = static_cast<I>(ex); }, buf);
  if (threadIdx.x == 0) ipre[C] = static_cast<I>(W);
  __syncthreads();
}

// Step 2, and the look-back descriptors of the W positions' tiles cleared;
// (s0, q0) the slot and position of the thread's first row, loaded at the
// kernel's start.
template <class I>
__device__ void scatter(const LayoutArgs& a, const I* soff, const I* moff, long long W,
                        long long s0, long long q0) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = tid; r < a.n; r += nthreads) {
    const long long s = r == tid ? s0 : a.assign[r];
    const long long q = r == tid ? q0 : a.seq[r];
    const long long o = soff ? static_cast<long long>(soff[s])
                             : static_cast<long long>(moff[a.rank[s]]);
    a.flat[o + q] = r;
  }
  const long long tiles = (W + kTile - 1) / kTile;
  for (long long t = tid; t < tiles; t += nthreads) a.desc[t] = 0;
}

// The center rank j in [lo, hi] of position i: the last j with ipre[j] <= i.
template <class I>
__device__ __forceinline__ long long center_of(const I* ipre, long long lo, long long hi,
                                               long long i) {
  while (lo < hi) {
    const long long mid = (lo + hi + 1) >> 1;
    if (static_cast<long long>(ipre[mid]) <= i) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// The count of the tiles before tile t > 0, by the calling warp: 32
// descriptors at a time, each awaited until its tile has published,
// back to the nearest one with an inclusive count.
__device__ long long look_back(const unsigned long long* desc, long long t) {
  const int lane = threadIdx.x & (kWarpSize - 1);
  long long sum = 0;
  for (long long p = t - 1;; p -= kWarpSize) {
    const long long q = p - lane;
    unsigned long long v = kInclusive;  // before tile 0: an inclusive count of 0
    if (q >= 0) {
      do {
        v = *reinterpret_cast<const volatile unsigned long long*>(desc + q);
      } while (v == 0);
    }
    const unsigned inc = __ballot_sync(kFullMask, (v >> 62) == 2);
    const int stop = inc ? __ffs(inc) - 1 : kWarpSize;
    sum += warp_sum(lane <= stop ? static_cast<long long>(v & kCount) : 0LL);
    if (inc) return sum;
  }
}

// Step 3 (see the header), over the ranks' arrays of type I, K positions a
// thread.
template <class I, int K>
__device__ void sweep(const LayoutArgs& a, const I* inv, const I* moff, const I* ipre,
                      long long C, long long W) {
  constexpr long long kSpan = K * kTile;
  __shared__ int s_row[kStageRows];         // the tile's member rows, from wlo
  __shared__ long long s_len[kStageRows];   // their lengths
  __shared__ int s_cen[kStageCenters];      // the tile's center rows, from jlo
  __shared__ long long s_lo[kStageCenters], s_hi[kStageCenters];  // their windows
  __shared__ long long s_meta[4];           // jlo, jhi, wlo, whi
  // the warps' kept pairs by (position row, warp), then their offsets
  __shared__ int s_cnt[K * kBigWarps];
  __shared__ long long s_base;  // the tile's first pair
  const int lane = threadIdx.x & (kWarpSize - 1);
  const int warp = threadIdx.x / kWarpSize;
  const long long d = a.delta;
  const long long tiles = (W + kSpan - 1) / kSpan;
  // the first position of center rank j's slice in flat, and its end
  auto slice_start = [&](long long j) { return static_cast<long long>(moff[max(0LL, j - d)]); };
  auto slice_end = [&](long long j) { return static_cast<long long>(moff[min(C - 1, j + d) + 1]); };
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long i0 = t * kSpan, i1 = min(W, i0 + kSpan);
    // the slices of ranks jlo..jhi are touched: the first and the last in
    // part, from i0 and up to i1 - 1; slices start and end in rank order.
    // Thread 0 finds jlo and the least position, thread 1 jhi and the
    // largest (the tile passes jlo's slice iff ipre[jlo + 1] < i1).
    if (threadIdx.x == 0) {
      const long long jlo = center_of(ipre, 0, C - 1, i0);
      long long wlo = slice_start(jlo) + (i0 - static_cast<long long>(ipre[jlo]));
      if (jlo + 1 < C && static_cast<long long>(ipre[jlo + 1]) < i1) {
        wlo = min(wlo, slice_start(jlo + 1));
      }
      s_meta[0] = jlo;
      s_meta[2] = wlo;
    } else if (threadIdx.x == 1) {
      const long long jhi = center_of(ipre, 0, C - 1, i1 - 1);
      long long whi = slice_start(jhi) + (i1 - static_cast<long long>(ipre[jhi]));
      if (static_cast<long long>(ipre[jhi]) > i0) whi = max(whi, slice_end(jhi - 1));
      s_meta[1] = jhi;
      s_meta[3] = whi;
    }
    __syncthreads();
    const long long jlo = s_meta[0], jhi = s_meta[1], wlo = s_meta[2], whi = s_meta[3];
    // past the staging's room (next to a cluster of thousands, or with
    // delta = 0, where each row is read once anyway) the tile reads global
    // memory
    const bool centers_staged = jhi - jlo < kStageCenters;
    const bool rows_staged = whi - wlo <= kStageRows;
    const long long nc = centers_staged ? jhi - jlo + 1 : 0;
    const long long nr = rows_staged ? whi - wlo : 0;
    {
      // up to two centers and two rows a thread (kStageRows = 2 kBig): each
      // level of their loads at once
      constexpr int kU = kStageRows / kBig;
      long long c[kU], r[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const long long k = threadIdx.x + u * kBig;
        c[u] = k < nc ? a.cen[inv[jlo + k]] : 0;
        r[u] = k < nr ? a.flat[wlo + k] : 0;
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const long long k = threadIdx.x + u * kBig;
        if (k < nc) {
          s_cen[k] = static_cast<int>(c[u]);
          s_lo[k] = a.blen[c[u]];
          s_hi[k] = a.elen[c[u]];
        }
        if (k < nr) {
          s_row[k] = static_cast<int>(r[u]);
          s_len[k] = a.lens[r[u]];
        }
      }
    }
    __syncthreads();
    long long r[K];
    int jk[K];       // the center's rank less jlo
    unsigned m[K];   // the warp's kept positions in each position row
#pragma unroll
    for (int p = 0; p < K; ++p) {
      const long long i = i0 + static_cast<long long>(p) * blockDim.x + threadIdx.x;
      bool keep = false;
      r[p] = 0;
      jk[p] = 0;
      if (i < i1) {
        const long long j = center_of(ipre, jlo, jhi, i);
        const long long x = slice_start(j) + (i - static_cast<long long>(ipre[j]));
        const long long k = j - jlo;
        long long lo, hi, len;
        if (centers_staged) {
          lo = s_lo[k];
          hi = s_hi[k];
        } else {
          const long long c = a.cen[inv[j]];
          lo = a.blen[c];
          hi = a.elen[c];
        }
        if (rows_staged) {
          r[p] = s_row[x - wlo];
          len = s_len[x - wlo];
        } else {
          r[p] = a.flat[x];
          len = a.lens[r[p]];
        }
        jk[p] = static_cast<int>(k);
        keep = len >= lo && len <= hi;
      }
      m[p] = __ballot_sync(kFullMask, keep);
      if (lane == 0) s_cnt[p * kBigWarps + warp] = __popc(m[p]);
    }
    __syncthreads();
    if (warp == 0) {
      // lane l takes the counts K l .. K l + K - 1, in position order
      int own[K], sum = 0;
#pragma unroll
      for (int q = 0; q < K; ++q) {
        own[q] = s_cnt[K * lane + q];
        sum += own[q];
      }
      int x = sum;  // inclusive scan of the lanes' sums
#pragma unroll
      for (int o = 1; o < kWarpSize; o <<= 1) {
        const int y = __shfl_up_sync(kFullMask, x, o);
        if (lane >= o) x += y;
      }
      const long long agg = __shfl_sync(kFullMask, x, kWarpSize - 1);
      long long before = 0;
      if (t == 0) {
        if (lane == 0) atomicExch(&a.desc[0], kInclusive | static_cast<unsigned long long>(agg));
      } else {
        if (lane == 0) atomicExch(&a.desc[t], kAggregate | static_cast<unsigned long long>(agg));
        before = look_back(a.desc, t);
        if (lane == 0) {
          atomicExch(&a.desc[t], kInclusive | static_cast<unsigned long long>(before + agg));
        }
      }
      int run = x - sum;
#pragma unroll
      for (int q = 0; q < K; ++q) {
        s_cnt[K * lane + q] = run;
        run += own[q];
      }
      if (lane == 0) {
        s_base = before;
        if (i1 == W) a.hdr[1] = before + agg;
      }
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < K; ++p) {
      if ((m[p] >> lane) & 1u) {
        const long long pos = s_base + s_cnt[p * kBigWarps + warp] +
                              __popc(m[p] & ((1u << lane) - 1u));
        const long long j = jlo + jk[p];
        a.a_rows[pos] = centers_staged ? static_cast<long long>(s_cen[jk[p]]) : a.cen[inv[j]];
        a.b_rows[pos] = r[p];
        a.seg[pos] = j;
      }
    }
    __syncthreads();  // the staging is rewritten by the next tile
  }
}

// WIDE: the ranks in the outputs and scratch (block 0, a second grid
// barrier); else in every block's shared memory, dynamic: soff [S],
// inv [S], moff [S + 1], ipre [S + 1] (int32).  K positions a thread.
template <bool WIDE, int K>
__global__ void __launch_bounds__(kBig) layout_kernel(LayoutArgs a) {
  extern __shared__ int slots[];
  __shared__ long long buf[kScanRows * kWarpSize];
  cg::grid_group grid = cg::this_grid();
  // the thread's first row for the scatter, loaded while the block ranks
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long s0 = tid < a.n ? a.assign[tid] : 0, q0 = tid < a.n ? a.seq[tid] : 0;
  long long C = 0, W = 0;
  if (!WIDE) {
    int* soff = slots;
    int* inv = soff + a.S;
    int* moff = inv + a.S;
    int* ipre = moff + a.S + 1;
    const long long per = (a.S + gridDim.x - 1) / gridDim.x;
    rank_slots<int>(a, soff, inv, moff, ipre, blockIdx.x * per, (blockIdx.x + 1) * per, buf,
                    C, W);
    // this block's share of inv and moff
    const long long pc = (C + gridDim.x) / gridDim.x;  // ceil((C + 1) / grid)
    const long long k1 = min(C + 1, (blockIdx.x + 1) * pc);
    for (long long k = blockIdx.x * pc + threadIdx.x; k < k1; k += blockDim.x) {
      if (k < C) a.inv[k] = inv[k];
      a.moff[k] = moff[k];
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) a.hdr[0] = C;
    scatter<int>(a, soff, moff, W, s0, q0);
    grid.sync();
    sweep<int, K>(a, inv, moff, ipre, C, W);
  } else {
    if (blockIdx.x == 0) {
      rank_slots<long long>(a, nullptr, a.inv, a.moff, a.ipre, 0, a.S, buf, C, W);
      if (threadIdx.x == 0) a.hdr[0] = C;
    }
    grid.sync();
    C = a.hdr[0];
    W = a.ipre[C];
    scatter<long long>(a, nullptr, a.moff, W, s0, q0);
    grid.sync();
    sweep<long long, K>(a, a.inv, a.moff, a.ipre, C, W);
  }
  if (W == 0 && blockIdx.x == 0 && threadIdx.x == 0) a.hdr[1] = 0;
}

// -- the merge replay ----------------------------------------------------------

struct ReplayArgs {
  long long n, S;
  const long long* assign;
  const long long* seq;
  const unsigned char* alive;
  const long long* clen;
  const long long* t_dst;
  long long* assign_out;
  long long* seq_out;
  unsigned char* alive_out;
  long long* clen_out;
  int* scratch;  // the wide instantiation's slot arrays: int32 [5 S]
};

// The events' offsets: an event's offset is acc[d], its destination's size
// before it, and acc[d] grows by the event's size, in ascending order of
// the events.  First every warp, for its chunks of 32 events, puts into
// off[s] the sizes of the event's lower siblings in the chunk (the lanes
// with its destination, grouped by __match_any_sync), as ~sum for the
// chunk's last sibling; then warp 0 walks the chunks in order, each step
// one read and one write of acc[d], the next chunk's loads in flight.
// Every thread of the block calls it; it ends with a block barrier.
__device__ void offsets(long long E, const int* ev, const int* dst, const int* size,
                        int* acc, int* off) {
  const int lane = threadIdx.x & (kWarpSize - 1);
  const int warp = threadIdx.x / kWarpSize;
  const long long chunks = (E + kWarpSize - 1) / kWarpSize;
  for (long long k = warp; k < chunks; k += blockDim.x / kWarpSize) {
    const long long e = k * kWarpSize + lane;
    const bool valid = e < E;
    const int s = valid ? ev[e] : 0;
    const int d = valid ? dst[s] : 0;
    const int f = valid ? size[s] : 0;
    const unsigned grp = __match_any_sync(kFullMask, valid ? d : -1 - lane);
    int before = 0;
    if (__any_sync(kFullMask, valid && (grp & (grp - 1u)) != 0u)) {
#pragma unroll
      for (int j = 0; j < kWarpSize; ++j) {
        const int v = __shfl_sync(kFullMask, f, j);
        if (j < lane && ((grp >> j) & 1u)) before += v;
      }
    }
    if (valid) off[s] = (grp >> lane) == 1u ? ~before : before;
  }
  __syncthreads();
  if (warp == 0 && chunks > 0) {
    int s = lane < E ? ev[lane] : 0;
    int d = lane < E ? dst[s] : 0;
    int v = lane < E ? off[s] : 0;
    int f = lane < E ? size[s] : 0;
    for (long long k = 0; k < chunks; ++k) {
      const bool valid = k * kWarpSize + lane < E;
      const long long en = (k + 1) * kWarpSize + lane;  // the next chunk's
      const int sn = en < E ? ev[en] : 0;
      const int dn = en < E ? dst[sn] : 0;
      const int vn = en < E ? off[sn] : 0;
      const int fn = en < E ? size[sn] : 0;
      const int base = valid ? acc[d] : 0;
      __syncwarp();
      if (valid) {
        const bool last = v < 0;
        const int before = last ? ~v : v;
        off[s] = base + before;
        if (last) acc[d] = base + before + f;
      }
      __syncwarp();
      s = sn;
      d = dn;
      v = vn;
      f = fn;
    }
  }
  __syncthreads();
}

// The slots' solution by the calling block in the int32 arrays size, fin,
// off, ev and pend [S]; with `write`, clen_out and alive_out too.  Returns
// in fin_out and tot_out the arrays that hold each slot's final slot and
// the offset its members move by.
__device__ void solve_slots(const ReplayArgs& a, int* size, int* fin, int* off, int* ev,
                            int* pend, long long* buf, bool write, int** fin_out,
                            int** tot_out) {
  const long long S = a.S;
  const long long* t_dst = a.t_dst;
  const unsigned char* alive = a.alive;
  const long long* clen = a.clen;
  for (long long s = threadIdx.x; s < S; s += blockDim.x) pend[s] = 0;
  __syncthreads();
  // the events, ascending; size[s] = clen[s], off[s] too for now; fin[s] =
  // an event's destination, else s; pend[d] = d's sources not yet applied
  const long long E = block_scan(
      S,
      [&](long long s) {
        const long long d = t_dst[s], c = clen[s];  // the slot's loads at once
        const bool event = alive[s] && d > s && d < S;
        size[s] = static_cast<int>(c);
        off[s] = static_cast<int>(c);
        fin[s] = static_cast<int>(event ? d : s);
        return event ? 1LL : 0LL;
      },
      [&](long long s, long long e, long long v) {
        if (v) {
          ev[e] = static_cast<int>(s);
          atomicAdd(&pend[fin[s]], 1);
        }
      },
      buf);
  // each event's size when it comes: clen plus its sources' sizes, in
  // rounds of the events whose sources are all applied (pend 0, then -1
  // while applied, -2 done); as many rounds as the longest chain
  for (;;) {
    for (long long e = threadIdx.x; e < E; e += blockDim.x) {
      const int s = ev[e];
      if (pend[s] == 0) pend[s] = -1;
    }
    __syncthreads();
    int left = 0;
    for (long long e = threadIdx.x; e < E; e += blockDim.x) {
      const int s = ev[e];
      const int p = pend[s];
      if (p == -1) {
        const int d = fin[s];
        atomicAdd(&size[d], size[s]);
        atomicSub(&pend[d], 1);
        pend[s] = -2;
      } else if (p >= 0) {
        left = 1;
      }
    }
    if (!__syncthreads_or(left)) break;
  }
  // pend becomes acc, each destination's size before its next source,
  // from clen in off; off is 0 until the events' offsets
  for (long long s = threadIdx.x; s < S; s += blockDim.x) {
    pend[s] = off[s];
    off[s] = 0;
  }
  __syncthreads();
  offsets(E, ev, fin, size, pend, off);
  if (write) {
    for (long long s = threadIdx.x; s < S; s += blockDim.x) {
      const bool moved = fin[s] != s;
      a.clen_out[s] = moved ? 0 : size[s];
      a.alive_out[s] = alive[s] && !moved ? 1 : 0;
    }
  }
  __syncthreads();  // ev and pend are free from here
  // path sums by pointer jumping: f0, t0 the current, f1, t1 the next
  int *f0 = fin, *t0 = off, *f1 = ev, *t1 = pend;
  for (;;) {
    int changed = 0;
    for (long long s = threadIdx.x; s < S; s += blockDim.x) {
      const int f = f0[s];
      const int ff = f0[f];
      f1[s] = ff;
      t1[s] = t0[s] + t0[f];  // a root's offset is 0
      changed |= ff != f;
    }
    int* sw = f0;
    f0 = f1;
    f1 = sw;
    sw = t0;
    t0 = t1;
    t1 = sw;
    if (!__syncthreads_or(changed)) break;
  }
  *fin_out = f0;
  *tot_out = t0;
}

// WIDE: block 0 solves the slots in scratch, then a grid barrier; else
// every block solves them in its shared memory, dynamic: size, fin, off,
// ev and pend [S] (int32).  Block 0 writes the slots'
// outputs; every block moves its share of the rows.
template <bool WIDE>
__global__ void __launch_bounds__(kBig) replay_kernel(ReplayArgs a) {
  extern __shared__ int slots[];
  __shared__ long long buf[kScanRows * kWarpSize];
  const long long S = a.S;
  int* base = WIDE ? a.scratch : slots;
  int* size = base;
  int* fin = base + S;
  int* off = base + 2 * S;
  int* ev = base + 3 * S;
  int* pend = base + 4 * S;
  int* fin_f = fin;
  int* tot_f = off;
  // the thread's first row, loaded while the block solves the slots
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long s0 = tid < a.n ? a.assign[tid] : 0, q0 = tid < a.n ? a.seq[tid] : 0;
  if (!WIDE || blockIdx.x == 0) {
    solve_slots(a, size, fin, off, ev, pend, buf, blockIdx.x == 0, &fin_f, &tot_f);
  }
  if (WIDE) {
    if (blockIdx.x == 0 && fin_f != fin) {  // the other blocks read fin and off
      for (long long s = threadIdx.x; s < S; s += blockDim.x) {
        fin[s] = fin_f[s];
        off[s] = tot_f[s];
      }
    }
    cg::this_grid().sync();
    fin_f = fin;
    tot_f = off;
  }
  const long long nthreads = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = tid; r < a.n; r += nthreads) {
    const long long s = r == tid ? s0 : a.assign[r];
    const long long q = r == tid ? q0 : a.seq[r];
    a.assign_out[r] = fin_f[s];
    a.seq_out[r] = q + tot_f[s];
  }
}

// Dynamic shared memory rounded up to 8 KB, so a run sees few sizes
long long round_shm(long long bytes) { return (bytes + 8191) / 8192 * 8192; }

// the layout's and the replay's slot arrays in bytes
long long layout_shm(long long S) { return round_shm(4 * (4 * S + 2)); }
long long replay_shm(long long S) { return round_shm(4 * 5 * S); }

// The dynamic shared memory a block of `kernel` may have beside its static
// shared memory on the current card; cached per (kernel, device).
cudaError_t shm_limit(const void* kernel, long long* limit) {
  struct Entry {
    const void* kernel;
    int dev;
    long long limit;
  };
  static Entry cache[16];
  static int n_cached = 0;
  static std::mutex mu;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_cached; ++i) {
    if (cache[i].kernel == kernel && cache[i].dev == dev) {
      *limit = cache[i].limit;
      return cudaSuccess;
    }
  }
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return e;
  *limit = static_cast<long long>(optin) - static_cast<long long>(fa.sharedSizeBytes);
  if (n_cached < 16) cache[n_cached++] = {kernel, dev, *limit};
  return cudaSuccess;
}

// The most slots whose arrays fit: the largest S with shm(S) <= limit.
long long most_slots(long long (*shm)(long long), long long limit) {
  long long lo = 0, hi = 1LL << 31;
  while (lo < hi) {
    const long long mid = (lo + hi + 1) / 2;
    if (shm(mid) <= limit) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// the shared-memory instantiations; the layout's K = 4 holds the most
// static shared memory, so its limit is the layout's
const void* layout_small() { return reinterpret_cast<const void*>(&layout_kernel<false, 4>); }
const void* replay_small() { return reinterpret_cast<const void*>(&replay_kernel<false>); }

}  // namespace

extern "C" {

// The most slots that phase_layout (kernel 0) or merge_replay (kernel 1)
// keeps in shared memory on the current card; above them the wide
// instantiation runs.  -1 on a CUDA error.
long long mc2_phase_smem_slots(int kernel) {
  long long limit = 0;
  if (shm_limit(kernel == 0 ? layout_small() : replay_small(), &limit) != cudaSuccess) {
    return -1;
  }
  return most_slots(kernel == 0 ? layout_shm : replay_shm, limit);
}

// scratch: int64 [S + 1 + ceil((2 delta + 1) n / 1,024)] (scratch_len
// elements); outputs as LayoutArgs; hdr int64 [2]
int mc2_phase_layout(long long n, long long S, int delta, const void* assign,
                     const void* seq, const void* alive, const void* cen,
                     const void* clen, const void* lens, const void* blen,
                     const void* elen, void* rank, void* inv, void* moff, void* flat,
                     void* a_rows, void* b_rows, void* seg, void* scratch,
                     long long scratch_len, void* hdr, void* stream) {
  const long long span = (2LL * delta + 1) * n;  // positions W are at most this
  const long long tiles = (span + kTile - 1) / kTile;
  if (n <= 0 || S <= 0 || delta < 0 || S > kLow32 / 2 || span > kLow32 / 2 ||
      scratch_len < S + 1 + tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long* sc = static_cast<long long*>(scratch);
  LayoutArgs a{n,
               S,
               delta,
               static_cast<const long long*>(assign),
               static_cast<const long long*>(seq),
               static_cast<const unsigned char*>(alive),
               static_cast<const long long*>(cen),
               static_cast<const long long*>(clen),
               static_cast<const long long*>(lens),
               static_cast<const long long*>(blen),
               static_cast<const long long*>(elen),
               static_cast<long long*>(rank),
               static_cast<long long*>(inv),
               static_cast<long long*>(moff),
               static_cast<long long*>(flat),
               static_cast<long long*>(a_rows),
               static_cast<long long*>(b_rows),
               static_cast<long long*>(seg),
               sc,
               reinterpret_cast<unsigned long long*>(sc + S + 1),
               static_cast<long long*>(hdr)};
  void* args[] = {&a};
  long long limit = 0;
  const cudaError_t e = shm_limit(layout_small(), &limit);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // K = 1 while the 1,024-position tiles fit on the card at once, else 4;
  // a block a tile at most, and a thread a row for the scatter
  const bool small = layout_shm(S) <= limit;
  const size_t shm = small ? static_cast<size_t>(layout_shm(S)) : 0;
  int cap = 0;
  const void* k1 = small ? reinterpret_cast<const void*>(&layout_kernel<false, 1>)
                         : reinterpret_cast<const void*>(&layout_kernel<true, 1>);
  const cudaError_t ec = coop_capacity(k1, shm, &cap, kBig);
  if (ec != cudaSuccess) return static_cast<int>(ec);
  const bool k4 = tiles > cap;
  const long long want = std::max(k4 ? (tiles + 3) / 4 : tiles, (n + kBig - 1) / kBig);
  const void* kernel =
      !k4 ? k1
          : (small ? layout_small() : reinterpret_cast<const void*>(&layout_kernel<true, 4>));
  return static_cast<int>(coop_launch(kernel, want, shm, args, st, kBig));
}

// scratch: int32 [5 S] (scratch_len elements) when S is
// above mc2_phase_smem_slots(1), else unused (may be null)
int mc2_merge_replay(long long n, long long S, const void* assign, const void* seq,
                     const void* alive, const void* clen, const void* t_dst,
                     void* assign_out, void* seq_out, void* alive_out, void* clen_out,
                     void* scratch, long long scratch_len, void* stream) {
  if (n <= 0 || S <= 0 || n > kLow32 / 2 || S > kLow32 / 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ReplayArgs a{n,
               S,
               static_cast<const long long*>(assign),
               static_cast<const long long*>(seq),
               static_cast<const unsigned char*>(alive),
               static_cast<const long long*>(clen),
               static_cast<const long long*>(t_dst),
               static_cast<long long*>(assign_out),
               static_cast<long long*>(seq_out),
               static_cast<unsigned char*>(alive_out),
               static_cast<long long*>(clen_out),
               static_cast<int*>(scratch)};
  long long limit = 0;
  cudaError_t e = shm_limit(replay_small(), &limit);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (replay_shm(S) <= limit) {
    // coop_capacity also allows the kernel this much dynamic shared memory
    const size_t shm = static_cast<size_t>(replay_shm(S));
    int cap = 0;
    e = coop_capacity(replay_small(), shm, &cap, kBig);
    if (e != cudaSuccess) return static_cast<int>(e);
    // a row a thread, up to the blocks that fit at once: every block
    // solves the slots, side by side
    const long long want = (n + kBig - 1) / kBig;
    replay_kernel<false><<<dim3(static_cast<unsigned>(std::min<long long>(want, cap))),
                           dim3(kBig), shm, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (scratch == nullptr || scratch_len < 5 * S) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* args[] = {&a};
  return static_cast<int>(coop_launch(reinterpret_cast<const void*>(&replay_kernel<true>),
                                      (n + kBig - 1) / kBig, 0, args, st, kBig));
}

}  // extern "C"
