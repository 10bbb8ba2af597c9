// The accumulate step's tail, in one launch: after the pair statistics and
// the float64 epilogue have given the W candidates of the open cluster's
// window their GLM sums s and dists (candidate as side a, the center as
// side b), decide the window, apply its case to the loop state on the card,
// and move the center to the member closest to the mean.
//
//   1. decisions (the host's Trainer::get_close, Trainer.cpp:22-71):
//        pos[p] = s[p] >= pos_edge                  (round(prob) > 0)
//        bit 1  = some |s[p] - pos_edge| <= max(8 s_err[p],
//                                              margin * max(|s[p]|, |pos_edge|, 1))
//        best   = the first position of the largest dist
//        bit 2  = some candidate within max(8 (dist_err[p] + dist_err[best]),
//                 tie_margin * max(|dist[best]|, 1)) of the best whose (stats,
//                 mags, selfdot, lens, stddev) differ from the best's, or,
//                 for a model with full-vector singles (full), whose row
//                 differs in a count: the host's float64 could rank them
//                 apart (meshclust2_tpu/cluster/device_loop.py l. 1118,
//                 1140-1147).  s_err and dist_err are the fused kernel's
//                 bounds (0 for other models, where the gates reduce to
//                 the relative margins).
//      The gates are formed with explicitly rounded float64 operations
//      (__dsub_rn, __dmul_rn), so nvcc's -fmad=true changes nothing.
//   2-3. the case, under the flags (bits, npos = the number of positives):
//        bits set      nothing changes (the host redoes the window);
//        npos == 0     the min case: cand[best] leaves the pool and opens
//                      cluster cid + 1 at stamp stepc, alone in the member
//                      list, and msum becomes its row;
//        otherwise     the positives get alive = 0, assign = cid, astep =
//                      stepc, are appended to members after the first mcnt
//                      in candidate order, and their column sums go into
//                      msum (integer atomics: the order of addition cannot
//                      matter).
//   4. when absorbing, closest-to-mean over the count = mcnt + npos members:
//      the round-half-up mean, sfloor and the g1-g3 guards from msum, then
//      per member dist2 = 2 sum_d min(h_d, r_d), mag = mags + sfloor, v =
//      10000 (1 - (dist2 / mag)^2); the first minimum; unc = a guard, or a
//      member within tie_margin of the minimum whose (dist2, mag) differ.
//   5. trip = (bits, npos, unc, cur_next): cur_next is members[first] when
//      absorbing and not unc, cand[best] in the min case, cur_d otherwise
//      (abort 2 absorbs the positives and keeps the center).
// The plain version is ops/window_absorb.py:window_step_ref; the state
// after every case is the same bit for bit (members[n], the plain version's
// scatter sink, excepted).
//
// Replaces, in one launch, what meshclust2_tpu/cluster/device_loop.py's
// program body does after the statistics (l. 1357-1467): the decision half
// of _build_program.scan_window._chunk_heavy (l. 1074-1209), the gated
// state updates, and closest_to_mean / _mc_heavy (l. 1223-1355), an XLA
// program jitted for the TPU over 2,048-row chunks in double-float32 with
// propagated error bounds.  Native float64 needs no error terms, and one
// launch covers the whole window, so the tie guard compares every candidate
// with the global best.
//
// What bounds it on an H100: at the accumulate loop's shapes (W ~ 1,600,
// ~15 positives, a few to a few thousand members, D = 1,024 uint8) it reads
// ~100 bytes a candidate and a row a positive and a member: ~0.2 MB, well
// under a microsecond of HBM time.  It is latency-bound: what counts is the
// number of launches, of grid-wide barriers and of dependent memory round
// trips.  The design:
//   - one cooperative launch (coop.cuh), grid = min(max(tiles of 256
//     candidates, (mcnt + W) / 64), co-resident blocks), in place of the
//     decision kernel, its torch.zeros, ~40 small torch launches of the
//     gated updates and two closest-to-mean launches;
//   - every block makes the window's decisions itself over all W
//     candidates (the reads repeat in L2), so no barrier precedes the case:
//     a window that aborts or closes its cluster needs none at all;
//   - each block owns a contiguous run of tiles, one candidate a thread: the
//     positives' member slots are the positives before the block plus a
//     ballot scan inside the tile; the tile's positives' rows are listed in
//     shared memory and summed a 4-byte word a thread, eight rows' loads in
//     flight (uint8 as two 16-bit lanes a word), into msum by one 64-bit
//     atomic a bin;
//   - when absorbing, one grid barrier (msum and the member list complete),
//     then the mean in shared memory in the row's own type (divisions
//     through the count's float64 reciprocal and one exact integer step),
//     one warp per member strided over the grid with DPX per-halfword
//     minima; the last block to finish (a count in the scratch, zeroed at
//     allocation and again by that block) combines the blocks' first
//     minima, sweeps the members for the tie guard and writes the trip.
// A plain launch sequence with last-block-done combines would need a second
// launch for the distances after msum is complete; one grid barrier is
// cheaper than a launch.
//
// The block mode (BLOCK, mc2_window_step_block_u8/u16) runs the same step on
// a rank of a row-sharded store (parallel/multihost_session.py): the counts
// hold only the store rows [row_lo, row_hi), at row - row_lo, while the
// moments, the window's decisions (gathered from every rank) and the loop
// state are every rank's alike.  Three launches, the collectives between
// them on the host:
//   phase 1  sections 1-3 above, every rank alike, but only the rank's own
//            positives' rows are summed, into `part` (int64 [d], zero
//            between steps) in place of msum; the min case's seed row goes
//            there too on its owner; the trip gets (bits, npos, 0, the min
//            case's seed or cur_d).  Then the host all-reduces `part` (SUM);
//   phase 2  msum += part (absorb) or msum = part (min case), part back to
//            zero; when absorbing, closest-to-mean over the rank's own
//            members: the rank's first minimum (v, position), its (dist2,
//            mag), the smallest v of its members whose (dist2, mag) differ
//            from that first's, and the mean's guard, into `rank_part`
//            (int64 [6]).  Then the host all-gathers the ranks' partials;
//   phase 3  one block: the first minimum over the ranks (the smallest v,
//            then position), and the tie guard from the partials: a member
//            within tie_margin of the minimum whose (dist2, mag) differ from
//            the first's exists exactly when the smallest such v, taken per
//            rank as its first's v where its first's integers differ from
//            the global first's and as its own smallest differing v
//            otherwise, lies within tie_margin; trip[2..3] as above.
// With one block covering every row the trip and the state are bit for bit
// the one-launch kernel's.  A model with full-vector singles (`full`) needs
// rows for the tie guard of section 2 and is not taken in block mode.
//
// Built by nvcc for sm_90a (ops/_build.py) and bound through ctypes: the
// entry points launch on the given stream, allocate nothing, do not
// synchronise and return the launch's error.

#include "coop.cuh"

namespace {

using namespace mc2;

constexpr int kTile = kThreads;          // candidates a tile, one a thread
constexpr int kMemberRowsPerBlock = 64;  // the grid's size for the distance pass
constexpr int kBatch = 8;                // rows a thread loads at once
// the scratch: trip (4), then per-block partials and the blocks-done count,
// then v / dist2 / mag per member
constexpr int kSlots = 4;

struct StepArgs {
  const void* counts;
  int d;
  const double* mags;
  const double* selfdot;
  const double* lens;
  const double* stddevs;
  const long long* order;  // flat position -> store row
  const long long* cand;   // [W] flat positions of the candidates
  long long n_cand;
  const double* s;
  const double* dist;
  const double* s_err;     // [W]
  const double* dist_err;  // [W]
  int full;                // 1: an exact tie needs equal rows
  const long long* stats;  // [W, 3]
  double pos_edge;
  double margin;
  double tie_margin;
  long long maxc;
  unsigned char* alive;    // [n] state, updated in place
  long long* assign;
  long long* astep;
  long long* members;      // [n + 1]
  long long* msum;         // [d]
  const long long* cur_d;  // may alias trip[3]
  long long cid;
  long long stepc;
  long long mcnt;
  long long* scratch;      // trip [4], partials [kSlots kMaxGrid], then [n + 1] x 3
  long long n;
  // the block mode
  long long row_lo;        // the counts hold store rows [row_lo, row_hi)
  long long row_hi;
  int phase;               // 1, 2 or 3
  long long* part;         // [d] the rank's partial column sums, 0 between steps
  long long* rank_part;    // [6] the rank's closest-to-mean partial (phase 2)
  const long long* parts;  // [n_parts, 6] every rank's, gathered (phase 3)
  int n_parts;
};

// The rank's partial of closest-to-mean (phase 2 of the block mode): its
// first minimum's v (bits) and member position (count for none), that
// member's dist2 and mag (-1 for none), the smallest v (bits) of its
// members whose (dist2, mag) differ from the first's (+inf for none), and
// whether the mean's guard fired.
constexpr int kPart = 6;

// Whether rows x and y hold the same d counts (VEC: 16-byte aligned rows
// of whole 16-byte words).
template <typename T, bool VEC>
__device__ bool rows_equal(const T* x, const T* y, int d) {
  if (VEC) {
    const uint4* u = reinterpret_cast<const uint4*>(x);
    const uint4* w = reinterpret_cast<const uint4*>(y);
    for (int i = 0; i < d * static_cast<int>(sizeof(T)) / 16; ++i) {
      const uint4 p = u[i], q = w[i];
      if (p.x != q.x || p.y != q.y || p.z != q.z || p.w != q.w) return false;
    }
    return true;
  }
  for (int i = 0; i < d; ++i) {
    if (x[i] != y[i]) return false;
  }
  return true;
}

// The pick of the block mode's phase 3 (one block): trip[2..3] from the
// ranks' partials when the step absorbed.
__device__ void block_pick(const StepArgs& a) {
  long long* trip = a.scratch;
  if (threadIdx.x != 0) return;
  const long long npos = trip[1];
  if (trip[0] != 0 || npos == 0) return;
  const long long count = a.mcnt + npos;
  const double inf = __longlong_as_double(0x7ff0000000000000LL);
  double mv = inf;
  long long fp = count, fd2 = -1, fmg = -1;
  int unc = 0;
  for (int g = 0; g < a.n_parts; ++g) {
    const long long* p = a.parts + kPart * g;
    const double v = __longlong_as_double(p[0]);
    if (before<false>(v, p[1], mv, fp)) {
      mv = v;
      fp = p[1];
      fd2 = p[2];
      fmg = p[3];
    }
    unc |= p[5] != 0;
  }
  if (fp < count) {
    double t = inf;  // the smallest v of a member whose integers differ
    for (int g = 0; g < a.n_parts; ++g) {
      const long long* p = a.parts + kPart * g;
      const bool differs = p[1] < count && (p[2] != fd2 || p[3] != fmg);
      const double v = differs ? __longlong_as_double(p[0]) : __longlong_as_double(p[4]);
      if (v < t) t = v;
    }
    const double thr = __dmul_rn(a.tie_margin, fmax(fabs(mv), 1.0));
    unc |= fabs(__dsub_rn(t, mv)) <= thr;
  }
  trip[2] = unc;
  trip[3] = (unc || fp >= count) ? *a.cur_d : a.members[fp];
}

template <typename T, bool VEC, bool BLOCK>
__global__ void __launch_bounds__(kThreads) window_step_kernel(const StepArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* r_s = reinterpret_cast<T*>(smem);  // [d] the mean (phase 4)
  __shared__ long long red[kWarps];
  __shared__ double red_v[kWarps];
  __shared__ long long red_p[kWarps];
  __shared__ int wcnt[kWarps];
  __shared__ long long pos_rows[kTile];  // a tile's positives' store rows
  __shared__ int last_s;

  cg::grid_group grid = cg::this_grid();
  const T* counts = static_cast<const T*>(a.counts);
  const int d = a.d;
  const int lane = threadIdx.x & (kWarpSize - 1);
  const int warp = threadIdx.x / kWarpSize;
  const int G = gridDim.x;
  const int b = blockIdx.x;
  const long long W = a.n_cand;
  const long long n_tiles = (W + kTile - 1) / kTile;
  const long long t0 = n_tiles * b / G;  // this block's tiles [t0, t1)
  const long long t1 = n_tiles * (b + 1) / G;
  const long long lo = t0 * kTile;
  long long* trip = a.scratch;
  long long* part = a.scratch + 4;
  double* p_cv = reinterpret_cast<double*>(part);  // per block: first minimum
  long long* p_cp = part + kMaxGrid;
  long long* p_guard = part + 2 * kMaxGrid;          // per block: mean guards
  unsigned* done = reinterpret_cast<unsigned*>(part + 3 * kMaxGrid);
  double* v_out = reinterpret_cast<double*>(part + kSlots * kMaxGrid);
  long long* d2_out = part + kSlots * kMaxGrid + (a.n + 1);
  long long* mag_out = part + kSlots * kMaxGrid + 2 * (a.n + 1);
  if (BLOCK && a.phase == 3) {
    if (b == 0) block_pick(a);
    return;
  }
  long long npos = 0;
  if (!BLOCK || a.phase == 1) {  // sections 1-3, the block mode's phase 1

  // 1. every block decides the whole window itself (W is a few thousand on
  // the main path, and the repeated reads hit L2), so that no grid barrier
  // comes before the case: the positives in all and before the block's
  // tiles, the margin gate, the first maximum
  long long pre = 0;
  int unc = 0;
  double bv = 0.0;
  long long bp = -1;
  {
    const double edge_abs = fabs(a.pos_edge);
#pragma unroll 4
    for (long long p = threadIdx.x; p < W; p += kThreads) {
      const double sp = a.s[p];
      const bool pos = sp >= a.pos_edge;
      npos += pos;
      pre += pos && p < lo;
      const double scale = fmax(fmax(fabs(sp), edge_abs), 1.0);
      const double mthr = __dmul_rn(a.margin, scale);
      const double thr = fmax(__dmul_rn(8.0, a.s_err[p]), mthr);
      unc |= fabs(__dsub_rn(sp, a.pos_edge)) <= thr;
      const double v = a.dist[p];
      if (bp < 0 || v > bv) {  // positions rise within a thread: first maximum
        bv = v;
        bp = p;
      }
    }
    npos = block_sum(npos, red);
    pre = block_sum(pre, red);
    unc = __syncthreads_or(unc);
    block_first<true>(bv, bp, red_v, red_p);  // W >= 1, so bp >= 0
  }

  // 2. the tie guard: candidates near the best whose inputs differ from its
  int tie = 0;
  {
    const long long br = a.order[a.cand[bp]];
    const long long* bs = a.stats + 3 * bp;
    const long long b0 = bs[0], b1 = bs[1], b2 = bs[2];
    const double bm = a.mags[br], bsd = a.selfdot[br], bl = a.lens[br], bd = a.stddevs[br];
    const double base = __dmul_rn(a.tie_margin, fmax(fabs(bv), 1.0));
    const double bde = a.dist_err[bp];
#pragma unroll 4
    for (long long p = threadIdx.x; p < W; p += kThreads) {
      const double v = a.dist[p];
      const double thr = fmax(__dmul_rn(8.0, __dadd_rn(a.dist_err[p], bde)), base);
      if (!(fabs(__dsub_rn(v, bv)) <= thr)) continue;
      const long long r = a.order[a.cand[p]];
      const long long* st = a.stats + 3 * p;
      bool same = v == bv && st[0] == b0 && st[1] == b1 && st[2] == b2 &&
                  a.mags[r] == bm && a.selfdot[r] == bsd && a.lens[r] == bl &&
                  a.stddevs[r] == bd;
      // the statistics and moments do not determine a full-vector single:
      // only the few near candidates compare their rows with the best's
      if (same && a.full) same = rows_equal<T, VEC>(counts + r * d, counts + br * d, d);
      tie |= !same;
    }
    tie = __syncthreads_or(tie);
  }

  // 3. the case: state updates of the block's candidates, member slots, and
  // the positives' column sums into msum
  const long long bits = (unc ? 1 : 0) | (tie ? 2 : 0);
  const bool absorb = bits == 0 && npos > 0;
  const bool is_min = bits == 0 && npos == 0;
  long long slot = a.mcnt + pre;  // the next positive's member slot
  for (long long t = t0; t < t1; ++t) {
    const long long p = t * kTile + threadIdx.x;
    const bool valid = p < W;
    const bool pa = absorb && valid && a.s[p] >= a.pos_edge;
    const unsigned ballot = __ballot_sync(kFullMask, pa);
    if (lane == 0) wcnt[warp] = __popc(ballot);
    __syncthreads();
    int in_tile = __popc(ballot & ((1u << lane) - 1u)), n_tile = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) in_tile += wcnt[w];
      n_tile += wcnt[w];
    }
    if (valid) {
      const long long c = a.cand[p];
      if (is_min && p == bp) {
        a.alive[c] = 0;
        a.assign[c] = a.cid + 1;
        a.astep[c] = a.stepc;
        a.members[0] = c;
      } else {
        a.alive[c] = pa ? 0 : 1;
        a.assign[c] = pa ? a.cid : -1;
        a.astep[c] = pa ? a.stepc : 0;
      }
      if (pa) {
        a.members[slot + in_tile] = c;
        const long long r = a.order[c];
        // block mode: the rank sums only the rows it holds
        pos_rows[in_tile] = !BLOCK ? r : (r >= a.row_lo && r < a.row_hi ? r - a.row_lo : -1);
      }
    }
    __syncthreads();  // pos_rows complete
    if (n_tile > 0) {
      unsigned long long* msum =
          reinterpret_cast<unsigned long long*>(BLOCK ? a.part : a.msum);
      if (VEC) {
        constexpr int kPer = 4 / sizeof(T);
        const int words = d / kPer;
        for (int w = threadIdx.x; w < words; w += kThreads) {
          unsigned acc[kPer] = {}, acc16[2] = {};  // <= 256 rows: both fit
          for (int k = 0; k < n_tile; k += kBatch) {  // kBatch loads in flight
            unsigned x[kBatch];
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              x[u] = k + u < n_tile && (!BLOCK || pos_rows[k + u] >= 0)
                         ? __ldg(reinterpret_cast<const unsigned*>(counts + pos_rows[k + u] * d) +
                                 w)
                         : 0u;
            }
#pragma unroll
            for (int u = 0; u < kBatch; ++u) add_word<T>(x[u], acc, acc16);
          }
          fold16<T>(acc, acc16);
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            if (acc[j]) atomicAdd(msum + w * kPer + j, static_cast<unsigned long long>(acc[j]));
          }
        }
      } else {
        for (int e = threadIdx.x; e < d; e += kThreads) {
          unsigned acc = 0;
          for (int k = 0; k < n_tile; ++k) {
            if (!BLOCK || pos_rows[k] >= 0) acc += counts[pos_rows[k] * d + e];
          }
          if (acc) atomicAdd(msum + e, static_cast<unsigned long long>(acc));
        }
      }
    }
    slot += n_tile;
    __syncthreads();  // before wcnt and pos_rows are reused
  }
  if (!absorb || BLOCK) {
    if (is_min && b == 0) {
      const long long r = a.order[a.cand[bp]];
      if (!BLOCK) {
        const T* row = counts + r * d;
        for (int e = threadIdx.x; e < d; e += kThreads) a.msum[e] = row[e];
      } else if (r >= a.row_lo && r < a.row_hi) {  // the seed's owner
        const T* row = counts + (r - a.row_lo) * d;
        for (int e = threadIdx.x; e < d; e += kThreads) a.part[e] = row[e];
      }
    }
    if (b == 0 && threadIdx.x == 0) {
      trip[0] = bits;
      trip[1] = npos;
      trip[2] = 0;
      trip[3] = is_min ? a.cand[bp] : *a.cur_d;
    }
    return;  // uniform over the grid: no block waits at a later barrier
  }
  }  // sections 1-3

  // block mode, phase 2: msum from the all-reduced partial sums, which go
  // back to zero
  if (BLOCK) {
    const long long bits_c = trip[0];
    npos = trip[1];
    const bool absorb_c = bits_c == 0 && npos > 0;
    const bool min_c = bits_c == 0 && npos == 0;
    for (long long e = static_cast<long long>(b) * kThreads + threadIdx.x; e < d;
         e += static_cast<long long>(G) * kThreads) {
      const long long x = a.part[e];
      a.part[e] = 0;
      if (absorb_c) a.msum[e] += x;
      if (min_c) a.msum[e] = x;
    }
    if (!absorb_c) return;  // uniform over the grid
  }
  grid.sync();

  // 4. closest-to-mean: the mean in shared memory, then one warp per member
  const long long count = a.mcnt + npos;
  {
    const double inv = 1.0 / static_cast<double>(count);
    long long sfloor = 0;
    int guard = 0;
    for (int e = threadIdx.x; e < d; e += kThreads) {
      const BinMean m = bin_mean(a.msum[e], count, inv, a.maxc);
      sfloor += m.q;
      guard |= m.guard;
      r_s[e] = static_cast<T>(m.r);
    }
    sfloor = block_sum(sfloor, red);  // its barriers also publish r_s
    guard = __syncthreads_or(guard);
    double best_v = __longlong_as_double(0x7ff0000000000000LL);  // +inf
    long long best_p = count;
    for (long long q = static_cast<long long>(b) * kWarps + warp; q < count;
         q += static_cast<long long>(G) * kWarps) {
      long long row = a.order[a.members[q]];
      if (BLOCK) {
        if (row < a.row_lo || row >= a.row_hi) {  // another rank's member
          if (lane == 0) d2_out[q] = -1;
          continue;
        }
        row -= a.row_lo;
      }
      const long long dist2 =
          2 * warp_sum(row_min_sum<T, VEC>(counts + row * d, r_s, d, lane));
      const long long mag =
          static_cast<long long>(a.mags[a.order[a.members[q]]]) + sfloor;
      const double v = distance_v(dist2, mag);
      if (lane == 0) {
        v_out[q] = v;
        d2_out[q] = dist2;
        mag_out[q] = mag;
      }
      if (v < best_v) {  // positions rise within the warp: first strict minimum
        best_v = v;
        best_p = q;
      }
    }
    block_first<false>(best_v, best_p, red_v, red_p);
    if (threadIdx.x == 0) {
      p_cv[b] = best_v;
      p_cp[b] = best_p;
      p_guard[b] = guard;
    }
  }

  // 5. the last block to finish combines the first minimum, sweeps the
  // members for the tie guard and writes the trip (a count in the scratch,
  // zeroed at allocation and again by that block, finds it)
  __threadfence();  // this block's partials and distances before its count
  __syncthreads();
  if (threadIdx.x == 0) last_s = atomicAdd(done, 1u) == static_cast<unsigned>(G - 1);
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  double mv = __longlong_as_double(0x7ff0000000000000LL);
  long long fp = count;
  int unc_m = 0;
  for (int i = threadIdx.x; i < G; i += kThreads) {
    const double v = __ldcg(p_cv + i);
    const long long q = __ldcg(p_cp + i);
    if (before<false>(v, q, mv, fp)) {
      mv = v;
      fp = q;
    }
    unc_m |= __ldcg(p_guard + i) != 0;
  }
  block_first<false>(mv, fp, red_v, red_p);
  if (BLOCK) {
    // the rank's partial: the smallest v of its members whose integers
    // differ from its first's
    const long long fd2 = fp < count ? __ldcg(d2_out + fp) : -1;
    const long long fmg = fp < count ? __ldcg(mag_out + fp) : -1;
    double sv = __longlong_as_double(0x7ff0000000000000LL);
    for (long long q = threadIdx.x; q < count; q += kThreads) {
      const long long d2 = __ldcg(d2_out + q);
      if (d2 < 0 || (d2 == fd2 && __ldcg(mag_out + q) == fmg)) continue;
      const double v = __ldcg(v_out + q);
      if (v < sv) sv = v;
    }
    long long dummy = 0;
    block_first<false>(sv, dummy, red_v, red_p);
    unc_m = __syncthreads_or(unc_m);
    if (threadIdx.x == 0) {
      long long* r = a.rank_part;
      r[0] = __double_as_longlong(mv);
      r[1] = fp;
      r[2] = fd2;
      r[3] = fmg;
      r[4] = __double_as_longlong(sv);
      r[5] = unc_m;
      *done = 0;
    }
    return;
  }
  if (fp < count) {
    const long long fd2 = __ldcg(d2_out + fp);
    const long long fmg = __ldcg(mag_out + fp);
    const double thr = __dmul_rn(a.tie_margin, fmax(fabs(mv), 1.0));
    for (long long q = threadIdx.x; q < count; q += kThreads) {
      const bool near = fabs(__dsub_rn(__ldcg(v_out + q), mv)) <= thr;
      unc_m |= near && !(__ldcg(d2_out + q) == fd2 && __ldcg(mag_out + q) == fmg);
    }
  }
  unc_m = __syncthreads_or(unc_m);
  if (threadIdx.x == 0) {
    trip[0] = 0;
    trip[1] = npos;
    trip[2] = unc_m;
    trip[3] = (unc_m || fp >= count) ? *a.cur_d : a.members[fp];
    *done = 0;
  }
}

template <typename T, bool BLOCK>
int launch(StepArgs a, long long scratch_len, void* stream) {
  if (a.d <= 0 || a.n_cand <= 0 || a.n < a.n_cand || a.mcnt < 0 ||
      a.mcnt + a.n_cand > a.n || !a.s_err || !a.dist_err ||
      scratch_len < 4 + kSlots * kMaxGrid + 3 * (a.n + 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (BLOCK && (a.full || a.phase < 1 || a.phase > 3 || a.row_lo < 0 ||
                a.row_hi < a.row_lo || !a.part || !a.rank_part ||
                (a.phase == 3 && (!a.parts || a.n_parts < 1)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = (static_cast<size_t>(a.d) * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.counts) % 16 == 0;
  const void* kernel = vec ? reinterpret_cast<const void*>(&window_step_kernel<T, true, BLOCK>)
                           : reinterpret_cast<const void*>(&window_step_kernel<T, false, BLOCK>);
  const long long tiles = (a.n_cand + kTile - 1) / kTile;
  const long long rows = (a.mcnt + a.n_cand + kMemberRowsPerBlock - 1) / kMemberRowsPerBlock;
  // the block mode's phases: the candidates' tiles, the members, one block
  const long long want = !BLOCK ? (tiles > rows ? tiles : rows)
                                : (a.phase == 1 ? tiles : (a.phase == 2 ? rows : 1));
  void* args[] = {&a};
  const cudaError_t e = coop_launch(kernel, want, static_cast<size_t>(a.d) * sizeof(T),
                                    args, static_cast<cudaStream_t>(stream));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

extern "C" {

// int64 words of scratch a pool of n flat positions needs
long long mc2_window_step_scratch_len(long long n) {
  return 4 + kSlots * kMaxGrid + 3 * (n + 1);
}

#define MC2_STEP_ENTRY(NAME, T)                                                         \
  int NAME(const void* counts, int d, const void* mags, const void* selfdot,            \
           const void* lens, const void* stddevs, const void* order, const void* cand,  \
           long long n_cand, const void* s, const void* dist, const void* s_err,        \
           const void* dist_err, int full, const void* stats,                           \
           double pos_edge, double margin, double tie_margin, long long maxc,           \
           void* alive, void* assign, void* astep, void* members, void* msum,           \
           const void* cur_d, long long cid, long long stepc, long long mcnt,           \
           void* scratch, long long scratch_len, long long n, void* stream) {           \
    StepArgs a{counts,                                                                  \
               d,                                                                       \
               static_cast<const double*>(mags),                                        \
               static_cast<const double*>(selfdot),                                     \
               static_cast<const double*>(lens),                                        \
               static_cast<const double*>(stddevs),                                     \
               static_cast<const long long*>(order),                                    \
               static_cast<const long long*>(cand),                                     \
               n_cand,                                                                  \
               static_cast<const double*>(s),                                           \
               static_cast<const double*>(dist),                                        \
               static_cast<const double*>(s_err),                                       \
               static_cast<const double*>(dist_err),                                    \
               full,                                                                    \
               static_cast<const long long*>(stats),                                    \
               pos_edge,                                                                \
               margin,                                                                  \
               tie_margin,                                                              \
               maxc,                                                                    \
               static_cast<unsigned char*>(alive),                                      \
               static_cast<long long*>(assign),                                         \
               static_cast<long long*>(astep),                                          \
               static_cast<long long*>(members),                                        \
               static_cast<long long*>(msum),                                           \
               static_cast<const long long*>(cur_d),                                    \
               cid,                                                                     \
               stepc,                                                                   \
               mcnt,                                                                    \
               static_cast<long long*>(scratch),                                        \
               n};                                                                      \
    return launch<T, false>(a, scratch_len, stream);                                    \
  }

MC2_STEP_ENTRY(mc2_window_step_u8, uint8_t)
MC2_STEP_ENTRY(mc2_window_step_u16, uint16_t)

#undef MC2_STEP_ENTRY

// The block mode: the same arguments (counts: the rank's rows [row_lo,
// row_hi); the moments: every store row's), then the block's, and the
// phase (1, 2, 3); part int64 [d], zero before phase 1; rank_part int64
// [6]; parts int64 [n_parts, 6], read in phase 3.
#define MC2_STEP_BLOCK_ENTRY(NAME, T)                                                   \
  int NAME(const void* counts, int d, const void* mags, const void* selfdot,            \
           const void* lens, const void* stddevs, const void* order, const void* cand,  \
           long long n_cand, const void* s, const void* dist, const void* s_err,        \
           const void* dist_err, int full, const void* stats,                           \
           double pos_edge, double margin, double tie_margin, long long maxc,           \
           void* alive, void* assign, void* astep, void* members, void* msum,           \
           const void* cur_d, long long cid, long long stepc, long long mcnt,           \
           void* scratch, long long scratch_len, long long n, long long row_lo,         \
           long long row_hi, int phase, void* part, void* rank_part, const void* parts, \
           int n_parts, void* stream) {                                                 \
    StepArgs a{counts,                                                                  \
               d,                                                                       \
               static_cast<const double*>(mags),                                        \
               static_cast<const double*>(selfdot),                                     \
               static_cast<const double*>(lens),                                        \
               static_cast<const double*>(stddevs),                                     \
               static_cast<const long long*>(order),                                    \
               static_cast<const long long*>(cand),                                     \
               n_cand,                                                                  \
               static_cast<const double*>(s),                                           \
               static_cast<const double*>(dist),                                        \
               static_cast<const double*>(s_err),                                       \
               static_cast<const double*>(dist_err),                                    \
               full,                                                                    \
               static_cast<const long long*>(stats),                                    \
               pos_edge,                                                                \
               margin,                                                                  \
               tie_margin,                                                              \
               maxc,                                                                    \
               static_cast<unsigned char*>(alive),                                      \
               static_cast<long long*>(assign),                                         \
               static_cast<long long*>(astep),                                          \
               static_cast<long long*>(members),                                        \
               static_cast<long long*>(msum),                                           \
               static_cast<const long long*>(cur_d),                                    \
               cid,                                                                     \
               stepc,                                                                   \
               mcnt,                                                                    \
               static_cast<long long*>(scratch),                                        \
               n,                                                                       \
               row_lo,                                                                  \
               row_hi,                                                                  \
               phase,                                                                   \
               static_cast<long long*>(part),                                           \
               static_cast<long long*>(rank_part),                                      \
               static_cast<const long long*>(parts),                                    \
               n_parts};                                                                \
    return launch<T, true>(a, scratch_len, stream);                                     \
  }

MC2_STEP_BLOCK_ENTRY(mc2_window_step_block_u8, uint8_t)
MC2_STEP_BLOCK_ENTRY(mc2_window_step_block_u16, uint16_t)

#undef MC2_STEP_BLOCK_ENTRY

}  // extern "C"
