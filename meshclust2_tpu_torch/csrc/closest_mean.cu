// Segmented closest-to-mean over a device-resident k-mer histogram store.
//
// Pairs p = 0..P-1 carry a row index rows[p], a segment id seg[p]
// (nondecreasing, in [0, C)) and a keep flag.  For each segment c, over its
// kept rows only:
//   n      = number of kept rows,  num_d = sum of their counts in bin d;
//   r_d    = floor((2 num_d + n) / (2 n))      the round-half-up mean;
//   sfloor = sum_d floor(num_d / n);
//   guard  = a float64 rounding corner in some bin (g1-g3, coop.cuh): the
//            host's double-valued mean could round or truncate differently;
//   per kept row: dist2 = 2 sum_d min(h_d, r_d),  mag = mags[row] + sfloor,
//            v = 10000 (1 - (dist2 / mag)^2)    (engine.distance_d);
//   first[c] = the first position p of the minimum v (P when no row is kept);
//   unc[c]   = guard, or a kept row whose v lies within tie_margin of the
//              minimum but whose (dist2, mag) differ from the first's.
// Where unc[c] is 0, first[c] is exactly the host's argmin: dist2 and mag are
// exact integers equal to the host's, and v is formed with explicitly rounded
// float64 operations (coop.cuh:distance_v).
//
// Replaces meshclust2_tpu/cluster/device_update.py:DeviceUpdater._closest_core
// (l. 290-364), an XLA program jitted for the TPU: segment_sum of a gathered
// [P, D] int32 block, then segment_min over double-float32 values.
//
// What bounds it on an H100: it reads every kept row twice (column sums,
// then the per-row distance), 2 K D sizeof(T) bytes for K kept rows at
// random rows, and does ~5-10 integer operations a 4-byte word on each
// pass.  The update phase's batches keep few of their positions (the 10k
// bench set: ~96,000 positions, ~10,000 kept, in ~800-1,150 segments of at
// most 550 positions and 50 kept rows; the 100k set: ~900,000 positions a
// batch, at most 5,500 positions and 500 kept rows a segment), so
// a block that walks every position of its segment row by row spends its
// time on the keep flags and row indices.  The design, one block of 256
// threads per segment:
//   - two binary searches over seg give the block its positions;
//   - per chunk of 256 positions, the kept rows are listed in shared memory
//     by a ballot scan; each thread sums its 4-byte words of them, eight
//     rows' loads in flight (uint8 as two 16-bit lanes a word, SWAR), into
//     the segment's int64 column sums in shared memory: no atomics;
//   - the mean, sfloor and guards per bin, the divisions by the count
//     through its float64 reciprocal and one exact integer step; the mean
//     in shared memory in the row's own type;
//   - the chunks listed again: one warp per kept row, Hopper's DPX
//     per-halfword minimum (__vimin3_u16x2) against the mean, v, dist2 and
//     mag to scratch; the block's first minimum; one sweep over the
//     segment for the tie guard.
// The largest segment sets the tail: ~0.2 us a kept row on one block.
//
// The phase instantiation (mc2_closest_candidates_u8/u16, CAND) also does
// the update phase's candidates step in the same launch, so the phase
// launches one kernel fewer a pass (csrc/phase.cu's state and layout):
// block k, the segment of center rank k, knows first[k] at its end and
//   - writes rank k's new center into cen_out[inv[k]]: the member
//     rows[first[k]], or with no kept member the old center cen[inv[k]], or
//     in the final delta = 0 pass the cluster's first member flat[moff[k]]
//     (the kept-empty rules of meshclust2_tpu/cluster/device_phase.py
//     l. 551-555, 611-622);
//   - takes part in the 2 delta merge candidates that read that center:
//     position i delta + q - 1 pairs rank i with rank i + q (q = 1..delta)
//     as (a = rank i + q's new center, b = rank i's, seg = i, ok = i + q <
//     C and a's length inside b's window; merge_pass.q_body, l. 462-517).
//     Each position has an arrival counter in `arrive` (int32, 0 between
//     launches): both of its blocks publish their centers, fence and add
//     one; the second to arrive writes the candidate and resets the
//     counter.  A position whose rank i + q is past C is written by block
//     i alone.  No block waits for another and none walks a serial tail.
// The slots that are not alive keep their centers (cen_out[s] = cen[s]),
// copied by all blocks by stride.  The per-iteration updater's
// instantiation (mc2_closest_mean_u8/u16) keeps its code.
//
// The phase instantiation's block mode (mc2_closest_candidates_block_u8/u16)
// runs it on a rank of a row-sharded store (parallel/multihost_session.py):
// the counts hold only the store rows [row_lo, row_hi), at row - row_lo,
// while mags, the layout and the state are every rank's alike.  A rank knows
// the filter's keep and uncertainty bits of its own pairs (those whose
// member row it holds) before any collective, and so its own kept rows.
// Three launches, the collectives between them on the host:
//   phase 1  the exchange, written whole in one launch, in 32-bit words
//            where a segment's column sums fit them (the wrapper's choice
//            from P maxc < 2^31: a segment keeps at most P rows), else in
//            64-bit words: the keep bits and the uncertainty bits of the
//            rank's own pairs, 32 positions a word (a warp's ballot), zeros
//            for the others' (blocks C ...), and per segment the column sums
//            of the rank's own kept rows (block c); every bit and sum has one
//            contributor, so the host's all-reduce (SUM) is exact;
//   phase 2  per segment, the mean from the all-reduced sums and the count
//            of the kept bits, then over the rank's own kept rows: its first
//            minimum (v, position), that row's (dist2, mag), the smallest v
//            of its rows whose (dist2, mag) differ from the first's, and the
//            guard, into rank_part (int64 [C, 6]); the host all-gathers the
//            ranks' partials;
//   phase 3  per segment, the first minimum over the ranks and the tie
//            guard from the partials (csrc/window_absorb.cu's block mode
//            derives the rule), first and unc, then the candidates step as
//            above; the slots that are not alive keep their centers.
// The arrival counters meet only blocks of one launch, so the candidates
// step stays in phase 3, after the ranks have met.  With one block covering
// every row, first, unc and the candidates are bit for bit the one-launch
// kernel's.
//
// Built by nvcc for sm_90a (ops/_build.py) and bound through ctypes: the
// entry points launch on the given stream, allocate nothing, do not
// synchronise and return the launch's error.

#include "coop.cuh"

namespace {

using namespace mc2;

constexpr int kTile = kThreads;  // positions a chunk, one a thread
constexpr int kBatch = 8;        // rows a thread loads at once (column sums)

struct SegArgs {
  const void* counts;
  int d;
  const double* mags;
  const long long* rows;
  const long long* seg;
  const unsigned char* keep;
  long long n_pairs;
  long long n_segs;
  long long maxc;
  double tie_margin;
  long long* scratch;
  long long* first;
  unsigned char* unc;
  // the block mode
  long long row_lo;        // the counts hold store rows [row_lo, row_hi)
  long long row_hi;
  int phase;               // 1, 2 or 3
  long long* rank_part;    // [C, 6] the rank's partials (phase 2)
  const long long* parts;  // [n_parts, C, 6] every rank's (phase 3)
  int n_parts;
  // the exchange (phases 1, 2): keep bits [nw], uncertainty bits [nw]
  // (nw = ceil(P / 32) words), column sums [C, d]; 32- or 64-bit words
  void* xbuf;
  int wide;
  const long long* own_cs;       // phase 1: [>= P] the rank's pairs in [0, p]
  const unsigned char* own_keep;  // [k] the filter's bits of the rank's pairs
  const unsigned char* own_unc;
};

// Word i of the exchange, either width.
__device__ __forceinline__ long long xword(const SegArgs& a, long long i) {
  return a.wide ? static_cast<const long long*>(a.xbuf)[i]
                : static_cast<long long>(static_cast<const int*>(a.xbuf)[i]);
}

__device__ __forceinline__ void xstore(const SegArgs& a, long long i, long long v) {
  if (a.wide) {
    static_cast<long long*>(a.xbuf)[i] = v;
  } else {
    static_cast<int*>(a.xbuf)[i] = static_cast<int>(v);
  }
}

// Whether position p is kept: the keep flags, or in the block mode's phase
// 2 the exchanged keep bits.
__device__ __forceinline__ bool kept_at(const SegArgs& a, long long p) {
  if (a.keep) return a.keep[p] != 0;
  return (xword(a, p >> 5) >> (p & 31)) & 1;
}

// A rank's partial of a segment (phase 2 of the block mode): its first
// minimum's v (bits) and position (P for none), that row's dist2 and mag
// (-1 for none), the smallest v (bits) of its kept rows whose (dist2, mag)
// differ from the first's (+inf for none), the guard.
constexpr int kPart = 6;

// The phase instantiation's inputs and outputs (csrc/phase.cu's Layout and
// PhaseState); rows above are the layout's member rows, the segments its
// center ranks, so C = n_segs and P = n_pairs.
struct CandArgs {
  long long S;
  int delta;
  int final_pass;
  const unsigned char* alive;  // [S]
  const long long* cen;        // [S]
  const long long* inv;        // [C]
  const long long* moff;       // [C + 1]
  const long long* flat;       // [n]
  const long long* lens;       // [n]
  const long long* blen;
  const long long* elen;
  int* arrive;         // [delta C], 0 between launches
  long long* cen_out;  // [S]
  long long* ca;       // [delta C]
  long long* cb;
  long long* cs;
  unsigned char* ok;
};

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

// List the kept positions among [base, base + kTile) of [lo, hi) in shared
// memory, in order: their store rows in t_row and, when t_pos is given,
// their positions.  Returns how many (the same in every thread).  BLOCK:
// the rank's own rows only, at row - row_lo.
template <bool BLOCK = false>
__device__ __forceinline__ int list_kept(const SegArgs& a, long long base, long long hi,
                                         long long* t_row, long long* t_pos, int* wk) {
  const int lane = threadIdx.x & (kWarpSize - 1);
  const int warp = threadIdx.x / kWarpSize;
  const long long p = base + threadIdx.x;
  bool kept = p < hi;
  if (BLOCK && kept) kept = a.rows[p] >= a.row_lo && a.rows[p] < a.row_hi;
  // the block mode's phase 1: the rank's own filter bits
  if (kept) kept = BLOCK && a.phase == 1 ? a.own_keep[a.own_cs[p] - 1] != 0 : kept_at(a, p);
  const unsigned bk = __ballot_sync(kFullMask, kept);
  __syncthreads();  // the previous chunk's lists are read no more
  if (lane == 0) wk[warp] = __popc(bk);
  __syncthreads();
  int ki = __popc(bk & ((1u << lane) - 1u)), nk = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) ki += wk[w];
    nk += wk[w];
  }
  if (kept) {
    t_row[ki] = a.rows[p] - (BLOCK ? a.row_lo : 0);
    if (t_pos) t_pos[ki] = p;
  }
  __syncthreads();
  return nk;
}

// The candidates step of rank k (the phase instantiation), at the end of
// its block: f = first[k], P for no kept member.  Every thread calls it.
__device__ __forceinline__ void candidates(const CandArgs& x, const long long* rows,
                                           long long P, long long C, long long k,
                                           long long f) {
  __shared__ long long ck[2];  // rank k's new center and its slot
  if (threadIdx.x == 0) {
    const long long s = x.inv[k];
    ck[0] = f < P ? rows[f] : (x.final_pass ? x.flat[x.moff[k]] : x.cen[s]);
    ck[1] = s;
    x.cen_out[s] = ck[0];
  }
  __syncthreads();
  const long long me = ck[0];
  const int d = x.delta;
  // t < d: k is rank i, its partner j = k + q; else k is rank j, i = k - q
  for (int t = threadIdx.x; t < 2 * d; t += blockDim.x) {
    const bool low = t < d;
    const int q = (low ? t : t - d) + 1;
    const long long i = low ? k : k - q;
    const long long j = i + q;
    if (i < 0) continue;
    const long long pos = i * d + q - 1;
    long long ci = me, cj = me;
    if (j < C) {
      // publish this block's center (the same value thread 0 wrote) before
      // arriving; the second to arrive reads the partner's through L2
      x.cen_out[ck[1]] = me;
      __threadfence();
      if (atomicAdd(&x.arrive[pos], 1) == 0) continue;
      __threadfence();
      x.arrive[pos] = 0;
      const long long other = __ldcg(&x.cen_out[x.inv[low ? j : i]]);
      ci = low ? me : other;
      cj = low ? other : me;
    }
    x.ca[pos] = cj;
    x.cb[pos] = ci;
    x.cs[pos] = i;
    x.ok[pos] = j < C && x.lens[cj] >= x.blen[ci] && x.lens[cj] <= x.elen[ci];
  }
}

// The pick of the block mode's phase 3 for segment c (thread 0): the first
// minimum over the ranks' partials and the tie guard.
__device__ void block_pick(const SegArgs& a, long long c, long long* f_out, int* unc_out) {
  const long long P = a.n_pairs;
  const double inf = __longlong_as_double(0x7ff0000000000000LL);
  double mv = inf;
  long long fp = P, fd2 = -1, fmg = -1;
  int unc = 0;
  for (int g = 0; g < a.n_parts; ++g) {
    const long long* p = a.parts + (static_cast<long long>(g) * a.n_segs + c) * kPart;
    const double v = __longlong_as_double(p[0]);
    if (before<false>(v, p[1], mv, fp)) {
      mv = v;
      fp = p[1];
      fd2 = p[2];
      fmg = p[3];
    }
    unc |= p[5] != 0;
  }
  if (fp < P) {
    double t = inf;  // the smallest v of a kept row whose integers differ
    for (int g = 0; g < a.n_parts; ++g) {
      const long long* p = a.parts + (static_cast<long long>(g) * a.n_segs + c) * kPart;
      const bool differs = p[1] < P && (p[2] != fd2 || p[3] != fmg);
      const double v = differs ? __longlong_as_double(p[0]) : __longlong_as_double(p[4]);
      if (v < t) t = v;
    }
    const double thr = __dmul_rn(a.tie_margin, fmax(fabs(mv), 1.0));
    unc |= fabs(__dsub_rn(t, mv)) <= thr;
  }
  *f_out = fp;
  *unc_out = unc;
}

template <typename T, bool VEC, bool CAND, bool BLOCK = false>
__global__ void __launch_bounds__(kThreads)
    closest_mean_kernel(const SegArgs a, const CandArgs x) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* num_s = reinterpret_cast<long long*>(smem);        // [d] column sums
  T* r_s = reinterpret_cast<T*>(smem + sizeof(long long) * a.d);  // [d] the mean
  __shared__ long long red[kWarps];
  __shared__ double red_v[kWarps];
  __shared__ long long red_p[kWarps];
  __shared__ long long t_row[kTile];  // a chunk's kept rows, in order
  __shared__ long long t_pos[kTile];  // and their positions
  __shared__ int wk[kWarps];
  __shared__ long long bounds[2];

  const T* counts = static_cast<const T*>(a.counts);
  const int d = a.d;
  const int lane = threadIdx.x & (kWarpSize - 1);
  const int warp = threadIdx.x / kWarpSize;
  const long long c = blockIdx.x;
  const long long P = a.n_pairs;
  double* v_out = reinterpret_cast<double*>(a.scratch);
  long long* d2_out = a.scratch + P;
  long long* mag_out = a.scratch + 2 * P;
  if (CAND && (!BLOCK || a.phase == 3)) {
    // the slots that are not alive keep their centers; a grid of one block
    // at C = 0 does only this
    for (long long s = c * kThreads + threadIdx.x; s < x.S;
         s += static_cast<long long>(gridDim.x) * kThreads) {
      if (!x.alive[s]) x.cen_out[s] = x.cen[s];
    }
    if (c >= a.n_segs) return;
  }
  if (BLOCK && a.phase == 1 && c >= a.n_segs) {
    // the exchange's bits: a warp's 32 positions a word, zeros for the
    // pairs of other ranks
    const long long p = (c - a.n_segs) * kTile + threadIdx.x;
    bool kb = false, ub = false;
    if (p < P && a.rows[p] >= a.row_lo && a.rows[p] < a.row_hi) {
      const long long i = a.own_cs[p] - 1;
      kb = a.own_keep[i] != 0;
      ub = a.own_unc[i] != 0;
    }
    const unsigned bk = __ballot_sync(kFullMask, kb);
    const unsigned bu = __ballot_sync(kFullMask, ub);
    const long long nw = (P + 31) / 32;
    const long long w = p >> 5;
    if (lane == 0 && w < nw) {
      xstore(a, w, static_cast<long long>(bk));  // a 32-bit word keeps the bits
      xstore(a, nw + w, static_cast<long long>(bu));
    }
    return;
  }
  if (BLOCK && a.phase == 3) {
    __shared__ long long f_s;
    if (threadIdx.x == 0) {
      int u = 0;
      block_pick(a, c, &f_s, &u);
      a.first[c] = f_s;
      a.unc[c] = u ? 1 : 0;
    }
    __syncthreads();
    candidates(x, a.rows, P, a.n_segs, c, f_s);
    return;
  }
  if (threadIdx.x == 0) bounds[0] = lower_bound(a.seg, P, c);
  if (threadIdx.x == 1) bounds[1] = lower_bound(a.seg, P, c + 1);
  for (int e = threadIdx.x; e < d; e += kThreads) num_s[e] = 0;
  __syncthreads();
  const long long lo = bounds[0];
  const long long hi = bounds[1];

  // 1. per chunk: the kept rows listed, each thread adds its words of them
  // (a thread owns its words across chunks, so no atomics); the block
  // mode's phase 2 has the sums in num and counts every kept row
  long long cnt = 0;
  const long long xnum = 2 * ((P + 31) / 32);  // the exchange's column sums
  if (BLOCK && a.phase == 2) {
    for (long long p = lo + threadIdx.x; p < hi; p += kThreads) cnt += kept_at(a, p);
    cnt = block_sum(cnt, red);
    for (int e = threadIdx.x; e < d; e += kThreads) num_s[e] = xword(a, xnum + c * d + e);
  }
  for (long long base = lo; base < hi && !(BLOCK && a.phase == 2); base += kTile) {
    const int nk = list_kept<BLOCK>(a, base, hi, t_row, nullptr, wk);
    cnt += nk;
    if (VEC) {
      constexpr int kPer = 4 / sizeof(T);
      const int words = d / kPer;
      for (int w = threadIdx.x; w < words; w += kThreads) {
        unsigned acc[kPer] = {}, acc16[2] = {};  // <= 256 rows: both fit
        for (int k = 0; k < nk; k += kBatch) {   // kBatch loads in flight
          unsigned x[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            x[u] = k + u < nk ? __ldg(reinterpret_cast<const unsigned*>(
                                          counts + t_row[k + u] * d) + w)
                              : 0u;
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) add_word<T>(x[u], acc, acc16);
        }
        fold16<T>(acc, acc16);
#pragma unroll
        for (int j = 0; j < kPer; ++j) num_s[w * kPer + j] += acc[j];
      }
    } else {
      for (int e = threadIdx.x; e < d; e += kThreads) {
        unsigned acc = 0;
        for (int k = 0; k < nk; ++k) acc += counts[t_row[k] * d + e];
        num_s[e] += acc;
      }
    }
  }

  __syncthreads();  // every word's sums complete
  if (BLOCK && a.phase == 1) {
    for (int e = threadIdx.x; e < d; e += kThreads) xstore(a, xnum + c * d + e, num_s[e]);
    return;
  }

  // 2. the mean, sfloor and the guards
  const long long den = cnt > 0 ? cnt : 1;
  const double inv = 1.0 / static_cast<double>(den);
  long long sfloor = 0;
  int guard = 0;
  for (int e = threadIdx.x; e < d; e += kThreads) {
    const BinMean m = bin_mean(num_s[e], den, inv, a.maxc);
    sfloor += m.q;
    guard |= m.guard;
    r_s[e] = static_cast<T>(m.r);
  }
  sfloor = block_sum(sfloor, red);  // its barriers also publish r_s
  guard = __syncthreads_or(guard);

  // 3. per chunk: the kept rows listed again, one warp per row; each warp's
  // rows rise in position, so its first strict minimum is the first
  const double inf = __longlong_as_double(0x7ff0000000000000LL);
  double best_v = inf;
  long long best_p = P;
  for (long long base = lo; base < hi; base += kTile) {
    const int nk = list_kept<BLOCK>(a, base, hi, t_row, t_pos, wk);
    for (int k = warp; k < nk; k += kWarps) {
      const long long row = t_row[k];
      const long long dist2 =
          2 * warp_sum(row_min_sum<T, VEC>(counts + row * d, r_s, d, lane));
      const long long mag = static_cast<long long>(a.mags[a.rows[t_pos[k]]]) + sfloor;
      const double v = distance_v(dist2, mag);
      if (lane == 0) {
        v_out[t_pos[k]] = v;
        d2_out[t_pos[k]] = dist2;
        mag_out[t_pos[k]] = mag;
      }
      if (v < best_v) {
        best_v = v;
        best_p = t_pos[k];
      }
    }
  }
  block_first<false>(best_v, best_p, red_v, red_p);  // publishes the scratch too

  if (BLOCK) {  // phase 2: the rank's partial
    const long long fd2 = best_p < P ? d2_out[best_p] : -1;
    const long long fmg = best_p < P ? mag_out[best_p] : -1;
    double sv = inf;
    for (long long p = lo + threadIdx.x; p < hi; p += kThreads) {
      const long long r = a.rows[p];
      if (!kept_at(a, p) || r < a.row_lo || r >= a.row_hi) continue;
      if (d2_out[p] == fd2 && mag_out[p] == fmg) continue;
      if (v_out[p] < sv) sv = v_out[p];
    }
    long long dummy = 0;
    block_first<false>(sv, dummy, red_v, red_p);
    if (threadIdx.x == 0) {
      long long* r = a.rank_part + c * kPart;
      r[0] = __double_as_longlong(best_v);
      r[1] = best_p;
      r[2] = fd2;
      r[3] = fmg;
      r[4] = __double_as_longlong(sv);
      r[5] = guard;
    }
    return;
  }

  // 4. tie guard: kept rows near the minimum whose integers differ from the
  // first's
  int tie = 0;
  if (best_p < P) {
    const long long fd2 = d2_out[best_p];
    const long long fmg = mag_out[best_p];
    const double thr = __dmul_rn(a.tie_margin, fmax(fabs(best_v), 1.0));
    for (long long p = lo + threadIdx.x; p < hi; p += kThreads) {
      if (!a.keep[p]) continue;
      const bool near = fabs(__dsub_rn(v_out[p], best_v)) <= thr;
      tie |= near && (d2_out[p] != fd2 || mag_out[p] != fmg);
    }
  }
  tie = __syncthreads_or(tie);
  if (threadIdx.x == 0) {
    a.first[c] = best_p;
    a.unc[c] = (guard || tie) ? 1 : 0;
  }
  if (CAND) candidates(x, a.rows, P, a.n_segs, c, best_p);
}

// CAND: the phase instantiation, a block also at C = 0 (the dead slots'
// copy); BLOCK: its block mode (phases 1 and 2 launch no block at C = 0)
template <typename T, bool CAND, bool BLOCK = false>
int launch(SegArgs a, const CandArgs& x, long long scratch_len, void* stream) {
  if (a.n_segs <= 0 && (!CAND || (BLOCK && a.phase != 3))) {
    return static_cast<int>(cudaSuccess);
  }
  // the scratch: v, dist2 and mag per position, which the block mode's
  // phases 1 and 3 do not write
  const bool scratch_ok = scratch_len >= 3 * a.n_pairs || (BLOCK && a.phase != 2);
  if (a.d <= 0 || a.n_pairs < 0 || a.n_segs < 0 || a.n_segs > 0x7fffffffLL || !scratch_ok) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (CAND && (x.S < a.n_segs || x.delta < 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (BLOCK && (a.phase < 1 || a.phase > 3 || a.row_lo < 0 || a.row_hi < a.row_lo ||
                (a.phase != 3 && !a.xbuf) || (a.phase == 1 && !a.own_cs) ||
                (a.phase == 2 && !a.rank_part) ||
                (a.phase == 3 && (!a.parts || a.n_parts < 1)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (BLOCK) a.keep = nullptr;  // phase 1 reads own_keep, phase 2 the exchanged bits
  const bool vec = (static_cast<size_t>(a.d) * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.counts) % 16 == 0;
  auto kernel = vec ? &closest_mean_kernel<T, true, CAND, BLOCK>
                    : &closest_mean_kernel<T, false, CAND, BLOCK>;
  const size_t shm = static_cast<size_t>(a.d) * (sizeof(long long) + sizeof(T));
  if (shm > 32 * 1024) {  // beside ~4.3 KB of static shared memory
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shm));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // the block mode's phase 1: a block a segment, then the bits' blocks
  const long long grid = (a.n_segs > 0 ? a.n_segs : 1) +
                         (BLOCK && a.phase == 1 ? (a.n_pairs + kTile - 1) / kTile : 0);
  kernel<<<dim3(static_cast<unsigned>(grid)), dim3(kThreads), shm,
           static_cast<cudaStream_t>(stream)>>>(a, x);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// scratch: int64 [>= 3 P] (v, dist2 and mag per position)
#define MC2_CLOSEST_ENTRY(NAME, T)                                                   \
  int NAME(const void* counts, int d, const void* mags, const void* rows,            \
           const void* seg, const void* keep, long long n_pairs, long long n_segs,   \
           long long maxc, double tie_margin, void* scratch, long long scratch_len,  \
           void* first_out, void* unc_out, void* stream) {                           \
    SegArgs a{counts,                                                                \
              d,                                                                     \
              static_cast<const double*>(mags),                                      \
              static_cast<const long long*>(rows),                                   \
              static_cast<const long long*>(seg),                                    \
              static_cast<const unsigned char*>(keep),                               \
              n_pairs,                                                               \
              n_segs,                                                                \
              maxc,                                                                  \
              tie_margin,                                                            \
              static_cast<long long*>(scratch),                                      \
              static_cast<long long*>(first_out),                                    \
              static_cast<unsigned char*>(unc_out)};                                 \
    return launch<T, false>(a, CandArgs{}, scratch_len, stream);                     \
  }

MC2_CLOSEST_ENTRY(mc2_closest_mean_u8, uint8_t)
MC2_CLOSEST_ENTRY(mc2_closest_mean_u16, uint16_t)

#undef MC2_CLOSEST_ENTRY

// The phase instantiation: the same arguments (rows and seg: the layout's
// first n_pairs b_rows and seg; n_segs = C), then the candidates' (S slots;
// alive, cen [S]; inv, moff, flat; lens, blen, elen [n]; arrive int32
// [delta C], zero; outputs cen_out [S], ca, cb, cs int64 and ok uint8
// [delta C]).  C = 0 launches one block, which copies the dead slots.
#define MC2_CANDIDATES_ENTRY(NAME, T)                                                \
  int NAME(const void* counts, int d, const void* mags, const void* rows,            \
           const void* seg, const void* keep, long long n_pairs, long long n_segs,   \
           long long maxc, double tie_margin, void* scratch, long long scratch_len,  \
           void* first_out, void* unc_out, long long S, int delta, int final_pass,   \
           const void* alive, const void* cen, const void* inv, const void* moff,    \
           const void* flat, const void* lens, const void* blen, const void* elen,   \
           void* arrive, void* cen_out, void* ca, void* cb, void* cs, void* ok,      \
           void* stream) {                                                           \
    SegArgs a{counts,                                                                \
              d,                                                                     \
              static_cast<const double*>(mags),                                      \
              static_cast<const long long*>(rows),                                   \
              static_cast<const long long*>(seg),                                    \
              static_cast<const unsigned char*>(keep),                               \
              n_pairs,                                                               \
              n_segs,                                                                \
              maxc,                                                                  \
              tie_margin,                                                            \
              static_cast<long long*>(scratch),                                      \
              static_cast<long long*>(first_out),                                    \
              static_cast<unsigned char*>(unc_out)};                                 \
    const CandArgs x{S,                                                              \
                     delta,                                                          \
                     final_pass,                                                     \
                     static_cast<const unsigned char*>(alive),                       \
                     static_cast<const long long*>(cen),                             \
                     static_cast<const long long*>(inv),                             \
                     static_cast<const long long*>(moff),                            \
                     static_cast<const long long*>(flat),                            \
                     static_cast<const long long*>(lens),                            \
                     static_cast<const long long*>(blen),                            \
                     static_cast<const long long*>(elen),                            \
                     static_cast<int*>(arrive),                                      \
                     static_cast<long long*>(cen_out),                               \
                     static_cast<long long*>(ca),                                    \
                     static_cast<long long*>(cb),                                    \
                     static_cast<long long*>(cs),                                    \
                     static_cast<unsigned char*>(ok)};                               \
    return launch<T, true>(a, x, scratch_len, stream);                               \
  }

MC2_CANDIDATES_ENTRY(mc2_closest_candidates_u8, uint8_t)
MC2_CANDIDATES_ENTRY(mc2_closest_candidates_u16, uint16_t)

#undef MC2_CANDIDATES_ENTRY

// The block mode: the phase instantiation's arguments (counts: the rank's
// rows [row_lo, row_hi); mags: every store row's; rows: global; keep: not
// read), then row_lo, row_hi, the phase (1, 2, 3), rank_part int64 [C, 6],
// parts int64 [n_parts, C, 6], the exchange xbuf (int64 words with wide,
// else int32: 2 ceil(P / 32) + C d of them), own_cs int64 [>= P], own_keep
// and own_unc uint8 [k].  Phase 1 reads the own_* arrays and writes xbuf,
// phase 2 reads the all-reduced xbuf and writes rank_part (and the scratch),
// phase 3 reads parts and writes first, unc and the candidates.
#define MC2_CANDIDATES_BLOCK_ENTRY(NAME, T)                                          \
  int NAME(const void* counts, int d, const void* mags, const void* rows,            \
           const void* seg, const void* keep, long long n_pairs, long long n_segs,   \
           long long maxc, double tie_margin, void* scratch, long long scratch_len,  \
           void* first_out, void* unc_out, long long S, int delta, int final_pass,   \
           const void* alive, const void* cen, const void* inv, const void* moff,    \
           const void* flat, const void* lens, const void* blen, const void* elen,   \
           void* arrive, void* cen_out, void* ca, void* cb, void* cs, void* ok,      \
           long long row_lo, long long row_hi, int phase, void* rank_part,           \
           const void* parts, int n_parts, void* xbuf, int wide, const void* own_cs, \
           const void* own_keep, const void* own_unc, void* stream) {                \
    SegArgs a{counts,                                                                \
              d,                                                                     \
              static_cast<const double*>(mags),                                      \
              static_cast<const long long*>(rows),                                   \
              static_cast<const long long*>(seg),                                    \
              static_cast<const unsigned char*>(keep),                               \
              n_pairs,                                                               \
              n_segs,                                                                \
              maxc,                                                                  \
              tie_margin,                                                            \
              static_cast<long long*>(scratch),                                      \
              static_cast<long long*>(first_out),                                    \
              static_cast<unsigned char*>(unc_out),                                  \
              row_lo,                                                                \
              row_hi,                                                                \
              phase,                                                                 \
              static_cast<long long*>(rank_part),                                    \
              static_cast<const long long*>(parts),                                  \
              n_parts,                                                               \
              xbuf,                                                                  \
              wide,                                                                  \
              static_cast<const long long*>(own_cs),                                 \
              static_cast<const unsigned char*>(own_keep),                           \
              static_cast<const unsigned char*>(own_unc)};                           \
    const CandArgs x{S,                                                              \
                     delta,                                                          \
                     final_pass,                                                     \
                     static_cast<const unsigned char*>(alive),                       \
                     static_cast<const long long*>(cen),                             \
                     static_cast<const long long*>(inv),                             \
                     static_cast<const long long*>(moff),                            \
                     static_cast<const long long*>(flat),                            \
                     static_cast<const long long*>(lens),                            \
                     static_cast<const long long*>(blen),                            \
                     static_cast<const long long*>(elen),                            \
                     static_cast<int*>(arrive),                                      \
                     static_cast<long long*>(cen_out),                               \
                     static_cast<long long*>(ca),                                    \
                     static_cast<long long*>(cb),                                    \
                     static_cast<long long*>(cs),                                    \
                     static_cast<unsigned char*>(ok)};                               \
    return launch<T, true, true>(a, x, scratch_len, stream);                         \
  }

MC2_CANDIDATES_BLOCK_ENTRY(mc2_closest_candidates_block_u8, uint8_t)
MC2_CANDIDATES_BLOCK_ENTRY(mc2_closest_candidates_block_u16, uint16_t)

#undef MC2_CANDIDATES_BLOCK_ENTRY

}  // extern "C"
