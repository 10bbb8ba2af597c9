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
//                 tie_margin * max(|dist[best]|, 1)) of the best whose dist
//                 differs from the best's or whose keys do (`tie`, a mask of
//                 the kTie* fields: those the model's dist reads, so that
//                 equal keys give the host equal dists too; all of the
//                 statistics, mags, selfdot, lens and stddev where a single
//                 is not one of the statistics'), or, for a
//                 model with full-vector singles (full), whose row differs
//                 in a count: the host's float64 could rank them apart
//                 (meshclust2_tpu/cluster/device_loop.py l. 1118,
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
// moments, the window's decisions and the loop state are every rank's
// alike.  A rank knows its own candidates' statistics and decisions from the
// center form of the fused kernel, and so its own positives (s >= pos_edge)
// and its own first maximum of dist, before any collective.  Three
// launches, two collectives between them on the host:
//   phase 1  the exchange (step_exchange_kernel), written whole in one
//            launch, int64 [xbuf_words(W, d, G)]: the statistics [W, 3] and
//            (s, dist, s_err, dist_err) [4, W] at the rank's own window
//            positions, zeros elsewhere; the column sums [d] of the rank's
//            own positives; and per rank g a seed slot of 1 + ceil(d
//            sizeof(T) / 8) words, slot `rank` holding its own first
//            maximum's window position + 1 and that row's bytes, the others
//            zero.  Every value has one contributor, so the host's
//            all-reduce (SUM) is exact and gives every rank the window's
//            statistics and decisions, its positives' column sums, and the
//            window's first maximum's row in its owner's slot (the first
//            maximum over the window is its owner's own first maximum);
//   phase 2  sections 1-5 above over the all-reduced exchange, no grid
//            barrier: the decisions, the case and the member slots, then,
//            when absorbing, every block forms the mean from msum plus the
//            column sums itself (msum's addend is complete when the launch
//            starts) and takes the members it can read without waiting for
//            another block: the earlier members [0, mcnt) strided over the
//            grid, and the positives of its own tiles, whose member slots it
//            wrote itself; only the rank's own rows, into the per-member
//            scratch.  The last block to arrive (the arrival count) writes
//            the rank's closest-to-mean partial into `rank_part` (int64 [6]:
//            its first minimum's v (bits) and member position, that member's
//            (dist2, mag), the smallest v of its members whose (dist2, mag)
//            differ from that first's, and the mean's guard) and only then
//            msum += the column sums: every other block has read msum before
//            it arrived.  The min case's seed row comes from the slot whose
//            position is the window's first maximum's.  Then the host
//            all-gathers the ranks' partials;
//   phase 3  one block: the first minimum over the ranks (the smallest v,
//            then position), and the tie guard from the partials: a member
//            within tie_margin of the minimum whose (dist2, mag) differ from
//            the first's exists exactly when the smallest such v, taken per
//            rank as its first's v where its first's integers differ from
//            the global first's and as its own smallest differing v
//            otherwise, lies within tie_margin; trip[2..3] as above.
// Phases 1 and 2 are plain launches (no block waits for another); a step has
// two collectives.  With one block covering every row the trip and the state
// are bit for bit the one-launch kernel's.  A model with full-vector singles
// (`full`) needs rows for the tie guard of section 2 and is not taken in
// block mode.
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
// the tie guard's keys (StepArgs::tie): the candidate's statistics and
// moments, and two exact integers some singles read alone, selfdot - 2 dot
// (the squared euclidean distance less the center's selfdot) and mags -
// 2 summin (the manhattan distance less the center's magnitude)
constexpr int kTieSummin = 1, kTieDot = 2, kTieEmd = 4, kTieMag = 8, kTieSelfdot = 16,
              kTieLen = 32, kTieStd = 64, kTieNorm2 = 128, kTieManh = 256;

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
  int tie;                 // the kTie* keys an exact tie needs equal
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
  long long* xbuf;         // the exchange, int64 [xbuf_words(W, d, G)] (phases 1, 2)
  int rank;                // this rank, of n_ranks
  int n_ranks;
  const long long* own_pos;    // phase 1: [k] the rank's candidates' window positions, rising
  const long long* own_rows;   // [k] their rows in the block (row - row_lo)
  long long n_own;             // k
  const long long* own_stats;  // [k, 3]
  const double* own_dec;       // [5, k]: s, prob, dist, s_err, dist_err
  long long* rank_part;    // [6] the rank's closest-to-mean partial (phase 2)
  const long long* parts;  // [n_ranks, 6] every rank's, gathered (phase 3)
};

// The rank's partial of closest-to-mean (phase 2 of the block mode): its
// first minimum's v (bits) and member position (count for none), that
// member's dist2 and mag (-1 for none), the smallest v (bits) of its
// members whose (dist2, mag) differ from the first's (+inf for none), and
// whether the mean's guard fired.
constexpr int kPart = 6;

// The exchange's regions (int64 words): statistics [W, 3] at 0, (s, dist,
// s_err, dist_err) [4, W] at 3 W, the positives' column sums [d] at 7 W,
// then n_ranks seed slots of seed_slot(d, size) words each.
__host__ __device__ inline long long seed_slot(int d, int size) {
  return 1 + (static_cast<long long>(d) * size + 7) / 8;
}

__host__ __device__ inline long long xbuf_words(long long w, int d, int size, int n_ranks) {
  return 7 * w + d + n_ranks * seed_slot(d, size);
}

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
  for (int g = 0; g < a.n_ranks; ++g) {
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
    for (int g = 0; g < a.n_ranks; ++g) {
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

// The block mode's phase 1: the exchange, written whole.  Blocks [0, Bp)
// cover the window positions (thread t zeroes position t if another rank
// owns it and writes the rank's own candidate t at own_pos[t]: every word
// has one writer), the next Bc blocks the column sums of the rank's own
// positives (a thread owns its 4-byte word of the rows, or its column,
// across the tiles of own candidates, as section 3 sums them), the last Bs
// blocks the seed slots (the blocks that cover slot `rank` find the rank's
// own first maximum of dist themselves).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads) step_exchange_kernel(const StepArgs a) {
  __shared__ long long pos_rows[kTile];
  __shared__ int wcnt[kWarps];
  __shared__ double red_v[kWarps];
  __shared__ long long red_p[kWarps];
  const T* counts = static_cast<const T*>(a.counts);
  const int d = a.d;
  const long long W = a.n_cand;
  const long long k = a.n_own;
  const int lane = threadIdx.x & (kWarpSize - 1);
  const int warp = threadIdx.x / kWarpSize;
  constexpr int kPer = VEC ? 4 / sizeof(T) : 1;
  const int words = d / kPer;  // a thread's share: a 4-byte word, or a column
  const long long bp_blocks = (W + kTile - 1) / kTile;
  const long long bc_blocks = (words + kThreads - 1) / kThreads;
  long long* x = a.xbuf;
  long long b = blockIdx.x;
  if (b < bp_blocks) {
    const long long t = b * kTile + threadIdx.x;
    if (t < W) {
      const long long r = a.order[a.cand[t]];
      if (r < a.row_lo || r >= a.row_hi) {
        x[3 * t] = x[3 * t + 1] = x[3 * t + 2] = 0;
#pragma unroll
        for (int j = 3; j < 7; ++j) x[j * W + t] = 0;
      }
    }
    if (t < k) {
      const long long p = a.own_pos[t];
#pragma unroll
      for (int j = 0; j < 3; ++j) x[3 * p + j] = a.own_stats[3 * t + j];
      x[3 * W + p] = __double_as_longlong(a.own_dec[t]);
      x[4 * W + p] = __double_as_longlong(a.own_dec[2 * k + t]);
      x[5 * W + p] = __double_as_longlong(a.own_dec[3 * k + t]);
      x[6 * W + p] = __double_as_longlong(a.own_dec[4 * k + t]);
    }
    return;
  }
  b -= bp_blocks;
  if (b < bc_blocks) {
    const int w = static_cast<int>(b) * kThreads + threadIdx.x;
    long long sum[kPer] = {};
    for (long long base = 0; base < k; base += kTile) {
      const long long i = base + threadIdx.x;
      const bool pos = i < k && a.own_dec[i] >= a.pos_edge;
      const unsigned ballot = __ballot_sync(kFullMask, pos);
      if (lane == 0) wcnt[warp] = __popc(ballot);
      __syncthreads();
      int in_tile = __popc(ballot & ((1u << lane) - 1u)), n_tile = 0;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        if (v < warp) in_tile += wcnt[v];
        n_tile += wcnt[v];
      }
      if (pos) pos_rows[in_tile] = a.own_rows[i];
      __syncthreads();  // pos_rows complete
      if (w < words) {
        if constexpr (VEC) {
          unsigned acc[kPer] = {}, acc16[2] = {};  // <= 256 rows: both fit
          for (int r = 0; r < n_tile; r += kBatch) {  // kBatch loads in flight
            unsigned xw[kBatch];
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              xw[u] = r + u < n_tile ? __ldg(reinterpret_cast<const unsigned*>(
                                                 counts + pos_rows[r + u] * d) + w)
                                     : 0u;
            }
#pragma unroll
            for (int u = 0; u < kBatch; ++u) add_word<T>(xw[u], acc, acc16);
          }
          fold16<T>(acc, acc16);
#pragma unroll
          for (int j = 0; j < kPer; ++j) sum[j] += acc[j];
        } else {
          for (int r = 0; r < n_tile; ++r) sum[0] += counts[pos_rows[r] * d + w];
        }
      }
      __syncthreads();  // before wcnt and pos_rows are reused
    }
    if (w < words) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) x[7 * W + static_cast<long long>(w) * kPer + j] = sum[j];
    }
    return;
  }
  b -= bc_blocks;
  const long long sw = seed_slot(d, sizeof(T));
  const long long w = b * kThreads + threadIdx.x;
  const long long mine = static_cast<long long>(a.rank) * sw;  // slot `rank`: [mine, mine + sw)
  long long bp = -1;
  if (k > 0 && b * kThreads < mine + sw && (b + 1) * kThreads > mine) {  // uniform
    double bv = 0.0;
    for (long long i = threadIdx.x; i < k; i += kThreads) {
      const double v = a.own_dec[2 * k + i];
      if (bp < 0 || v > bv) {  // positions rise within a thread: first maximum
        bv = v;
        bp = i;
      }
    }
    block_first<true>(bv, bp, red_v, red_p);
  }
  if (w >= a.n_ranks * sw) return;
  long long val = 0;
  if (bp >= 0 && w >= mine && w < mine + sw) {
    if (w == mine) {
      val = a.own_pos[bp] + 1;
    } else {
      const long long nbytes = static_cast<long long>(d) * sizeof(T);
      const long long off = 8 * (w - mine - 1);
      const unsigned char* row =
          reinterpret_cast<const unsigned char*>(counts + a.own_rows[bp] * d);
      for (int u = 0; u < 8; ++u) {
        if (off + u < nbytes) val |= static_cast<long long>(row[off + u]) << (8 * u);
      }
    }
  }
  x[7 * W + d + w] = val;
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
  // the block mode's phase 2: the window's statistics and decisions and the
  // positives' column sums from the all-reduced exchange
  const long long* colsum = BLOCK ? a.xbuf + 7 * W : nullptr;

  // 1. every block decides the whole window itself (W is a few thousand on
  // the main path, and the repeated reads hit L2), so that no grid barrier
  // comes before the case: the positives in all and before the block's
  // tiles, the margin gate, the first maximum
  long long npos = 0, pre = 0;
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
    const int keys = a.tie;
#pragma unroll 4
    for (long long p = threadIdx.x; p < W; p += kThreads) {
      const double v = a.dist[p];
      const double thr = fmax(__dmul_rn(8.0, __dadd_rn(a.dist_err[p], bde)), base);
      if (!(fabs(__dsub_rn(v, bv)) <= thr)) continue;
      const long long r = a.order[a.cand[p]];
      const long long* st = a.stats + 3 * p;
      bool same = v == bv && (!(keys & kTieSummin) || st[0] == b0) &&
                  (!(keys & kTieDot) || st[1] == b1) && (!(keys & kTieEmd) || st[2] == b2) &&
                  (!(keys & kTieMag) || a.mags[r] == bm) &&
                  (!(keys & kTieSelfdot) || a.selfdot[r] == bsd) &&
                  (!(keys & kTieLen) || a.lens[r] == bl) &&
                  (!(keys & kTieStd) || a.stddevs[r] == bd);
      // exact integers below 2^53 in float64: the subtractions are exact
      if (same && (keys & kTieNorm2)) {
        same = __dsub_rn(a.selfdot[r], 2.0 * static_cast<double>(st[1])) ==
               __dsub_rn(bsd, 2.0 * static_cast<double>(b1));
      }
      if (same && (keys & kTieManh)) {
        same = __dsub_rn(a.mags[r], 2.0 * static_cast<double>(st[0])) ==
               __dsub_rn(bm, 2.0 * static_cast<double>(b0));
      }
      // the statistics and moments do not determine a full-vector single:
      // only the few near candidates compare their rows with the best's
      if (same && a.full) same = rows_equal<T, VEC>(counts + r * d, counts + br * d, d);
      tie |= !same;
    }
    tie = __syncthreads_or(tie);
  }

  // 3. the case: state updates of the block's candidates, member slots, and
  // (one-launch kernel) the positives' column sums into msum
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
        if (!BLOCK) pos_rows[in_tile] = a.order[c];
      }
    }
    __syncthreads();  // pos_rows complete
    if (!BLOCK && n_tile > 0) {
      unsigned long long* msum = reinterpret_cast<unsigned long long*>(a.msum);
      if (VEC) {
        constexpr int kPer = 4 / sizeof(T);
        const int words = d / kPer;
        for (int w = threadIdx.x; w < words; w += kThreads) {
          unsigned acc[kPer] = {}, acc16[2] = {};  // <= 256 rows: both fit
          for (int k = 0; k < n_tile; k += kBatch) {  // kBatch loads in flight
            unsigned x[kBatch];
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              x[u] = k + u < n_tile
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
          for (int k = 0; k < n_tile; ++k) acc += counts[pos_rows[k] * d + e];
          if (acc) atomicAdd(msum + e, static_cast<unsigned long long>(acc));
        }
      }
    }
    slot += n_tile;
    __syncthreads();  // before wcnt and pos_rows are reused
  }
  if (!absorb) {
    if (is_min && b == 0) {
      if (!BLOCK) {
        const T* row = counts + a.order[a.cand[bp]] * d;
        for (int e = threadIdx.x; e < d; e += kThreads) a.msum[e] = row[e];
      } else {
        // the seed's row, from the slot of its owner: the one whose own
        // first maximum is the window's
        const long long sw = seed_slot(d, sizeof(T));
        const long long* seeds = a.xbuf + 7 * W + d;
        __shared__ int g_s;
        if (threadIdx.x == 0) {
          g_s = -1;
          for (int g = 0; g < a.n_ranks && g_s < 0; ++g) {
            if (seeds[g * sw] == bp + 1) g_s = g;
          }
        }
        __syncthreads();
        if (g_s >= 0) {
          const T* row = reinterpret_cast<const T*>(seeds + g_s * sw + 1);
          for (int e = threadIdx.x; e < d; e += kThreads) a.msum[e] = row[e];
        }
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
  if (!BLOCK) {
    cg::this_grid().sync();  // msum and the member list complete
  }
  // (block mode: __syncthreads above published the block's member slots)

  // 4. closest-to-mean: the mean in shared memory, then one warp per member
  const long long count = a.mcnt + npos;
  {
    const double inv = 1.0 / static_cast<double>(count);
    long long sfloor = 0;
    int guard = 0;
    for (int e = threadIdx.x; e < d; e += kThreads) {
      const long long num = BLOCK ? a.msum[e] + colsum[e] : a.msum[e];
      const BinMean m = bin_mean(num, count, inv, a.maxc);
      sfloor += m.q;
      guard |= m.guard;
      r_s[e] = static_cast<T>(m.r);
    }
    sfloor = block_sum(sfloor, red);  // its barriers also publish r_s
    guard = __syncthreads_or(guard);
    double best_v = __longlong_as_double(0x7ff0000000000000LL);  // +inf
    long long best_p = count;
    auto member = [&](long long q) {
      long long row = a.order[a.members[q]];
      if (BLOCK) {
        if (row < a.row_lo || row >= a.row_hi) {  // another rank's member
          if (lane == 0) d2_out[q] = -1;
          return;
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
    };
    // the block mode reads only the member slots it can see: the earlier
    // members over the grid, then the positives of its own tiles, whose
    // slots [mcnt + pre, slot) it wrote itself (and above every earlier one)
    const long long spread = BLOCK ? a.mcnt : count;
    for (long long q = static_cast<long long>(b) * kWarps + warp; q < spread;
         q += static_cast<long long>(G) * kWarps) {
      member(q);
    }
    if (BLOCK) {
      for (long long q = a.mcnt + pre + warp; q < slot; q += kWarps) member(q);
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
    // every block has formed its mean: msum takes the column sums now
    for (int e = threadIdx.x; e < d; e += kThreads) a.msum[e] += colsum[e];
    if (threadIdx.x == 0) {
      long long* r = a.rank_part;
      r[0] = __double_as_longlong(mv);
      r[1] = fp;
      r[2] = fd2;
      r[3] = fmg;
      r[4] = __double_as_longlong(sv);
      r[5] = unc_m;
      trip[0] = 0;
      trip[1] = npos;
      trip[2] = 0;
      trip[3] = *a.cur_d;
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

template <typename T>
bool vec_rows(const StepArgs& a) {
  return (static_cast<size_t>(a.d) * sizeof(T)) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(a.counts) % 16 == 0;
}

template <typename T>
int launch(StepArgs a, long long scratch_len, void* stream) {
  if (a.d <= 0 || a.n_cand <= 0 || a.n < a.n_cand || a.mcnt < 0 ||
      a.mcnt + a.n_cand > a.n || !a.s_err || !a.dist_err ||
      scratch_len < 4 + kSlots * kMaxGrid + 3 * (a.n + 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* kernel = vec_rows<T>(a)
                           ? reinterpret_cast<const void*>(&window_step_kernel<T, true, false>)
                           : reinterpret_cast<const void*>(&window_step_kernel<T, false, false>);
  const long long tiles = (a.n_cand + kTile - 1) / kTile;
  const long long rows = (a.mcnt + a.n_cand + kMemberRowsPerBlock - 1) / kMemberRowsPerBlock;
  void* args[] = {&a};
  const cudaError_t e = coop_launch(kernel, tiles > rows ? tiles : rows,
                                    static_cast<size_t>(a.d) * sizeof(T), args,
                                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// The block mode's phases: 1 the exchange, 2 the step over it, 3 the pick.
template <typename T>
int launch_block(StepArgs a, long long scratch_len, long long xbuf_len, void* stream) {
  const long long W = a.n_cand;
  const bool bad_common = a.d <= 0 || W <= 0 || a.n < W || a.row_lo < 0 ||
                          a.row_hi < a.row_lo || a.n_ranks < 1 || a.rank < 0 ||
                          a.rank >= a.n_ranks;
  const bool bad_x = !a.xbuf || xbuf_len < xbuf_words(W, a.d, sizeof(T), a.n_ranks);
  bool bad = bad_common;
  if (a.phase == 1) {
    bad |= bad_x || a.n_own < 0 || a.n_own > W ||
           (a.n_own > 0 && (!a.own_pos || !a.own_rows || !a.own_stats || !a.own_dec));
  } else if (a.phase == 2) {
    bad |= bad_x || a.mcnt < 0 || a.mcnt + W > a.n || !a.rank_part ||
           scratch_len < 4 + kSlots * kMaxGrid + 3 * (a.n + 1);
  } else if (a.phase == 3) {
    bad |= !a.parts || scratch_len < 4;
  } else {
    bad = true;
  }
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = vec_rows<T>(a);
  void* args[] = {&a};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (a.phase == 1) {
    const long long words = vec ? a.d * static_cast<long long>(sizeof(T)) / 4 : a.d;
    const long long grid = (W + kTile - 1) / kTile + (words + kThreads - 1) / kThreads +
                           (a.n_ranks * seed_slot(a.d, sizeof(T)) + kThreads - 1) / kThreads;
    const void* kernel = vec ? reinterpret_cast<const void*>(&step_exchange_kernel<T, true>)
                             : reinterpret_cast<const void*>(&step_exchange_kernel<T, false>);
    e = cudaLaunchKernel(kernel, dim3(static_cast<unsigned>(grid)), dim3(kThreads), args, 0, st);
  } else {
    const void* kernel = vec ? reinterpret_cast<const void*>(&window_step_kernel<T, true, true>)
                             : reinterpret_cast<const void*>(&window_step_kernel<T, false, true>);
    // phase 2: the candidates' tiles or the earlier members, 64 a block
    const long long tiles = (W + kTile - 1) / kTile;
    const long long rows = (a.mcnt + kMemberRowsPerBlock - 1) / kMemberRowsPerBlock;
    const long long want = a.phase == 3 ? 1 : (tiles > rows ? tiles : rows);
    if (a.phase == 2) {
      a.stats = a.xbuf;
      a.s = reinterpret_cast<const double*>(a.xbuf + 3 * W);
      a.dist = reinterpret_cast<const double*>(a.xbuf + 4 * W);
      a.s_err = reinterpret_cast<const double*>(a.xbuf + 5 * W);
      a.dist_err = reinterpret_cast<const double*>(a.xbuf + 6 * W);
    }
    e = plain_launch(kernel, want, static_cast<size_t>(a.d) * sizeof(T), args, st);
  }
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

extern "C" {

// int64 words of scratch a pool of n flat positions needs
long long mc2_window_step_scratch_len(long long n) {
  return 4 + kSlots * kMaxGrid + 3 * (n + 1);
}

// int64 words of the block mode's exchange for a window of w candidates,
// rows of d counts of `size` bytes, n_ranks ranks
long long mc2_window_step_xbuf_len(long long w, int d, int size, int n_ranks) {
  return xbuf_words(w, d, size, n_ranks);
}

#define MC2_STEP_ENTRY(NAME, T)                                                         \
  int NAME(const void* counts, int d, const void* mags, const void* selfdot,            \
           const void* lens, const void* stddevs, const void* order, const void* cand,  \
           long long n_cand, const void* s, const void* dist, const void* s_err,        \
           const void* dist_err, int full, const void* stats,                           \
           double pos_edge, double margin, double tie_margin, long long maxc,           \
           void* alive, void* assign, void* astep, void* members, void* msum,           \
           const void* cur_d, long long cid, long long stepc, long long mcnt,           \
           void* scratch, long long scratch_len, long long n, int tie, void* stream) {  \
    StepArgs a{};                                                                       \
    a.counts = counts;                                                                  \
    a.d = d;                                                                            \
    a.mags = static_cast<const double*>(mags);                                          \
    a.selfdot = static_cast<const double*>(selfdot);                                    \
    a.lens = static_cast<const double*>(lens);                                          \
    a.stddevs = static_cast<const double*>(stddevs);                                    \
    a.order = static_cast<const long long*>(order);                                     \
    a.cand = static_cast<const long long*>(cand);                                       \
    a.n_cand = n_cand;                                                                  \
    a.s = static_cast<const double*>(s);                                                \
    a.dist = static_cast<const double*>(dist);                                          \
    a.s_err = static_cast<const double*>(s_err);                                        \
    a.dist_err = static_cast<const double*>(dist_err);                                  \
    a.full = full;                                                                      \
    a.tie = tie;                                                                        \
    a.stats = static_cast<const long long*>(stats);                                     \
    a.pos_edge = pos_edge;                                                              \
    a.margin = margin;                                                                  \
    a.tie_margin = tie_margin;                                                          \
    a.maxc = maxc;                                                                      \
    a.alive = static_cast<unsigned char*>(alive);                                       \
    a.assign = static_cast<long long*>(assign);                                         \
    a.astep = static_cast<long long*>(astep);                                           \
    a.members = static_cast<long long*>(members);                                       \
    a.msum = static_cast<long long*>(msum);                                             \
    a.cur_d = static_cast<const long long*>(cur_d);                                     \
    a.cid = cid;                                                                        \
    a.stepc = stepc;                                                                    \
    a.mcnt = mcnt;                                                                      \
    a.scratch = static_cast<long long*>(scratch);                                       \
    a.n = n;                                                                            \
    return launch<T>(a, scratch_len, stream);                                           \
  }

MC2_STEP_ENTRY(mc2_window_step_u8, uint8_t)
MC2_STEP_ENTRY(mc2_window_step_u16, uint16_t)

#undef MC2_STEP_ENTRY

// The block mode, one phase a call (counts: the rank's rows [row_lo,
// row_hi); the moments: every store row's).  Phase 1 reads order, cand, the
// rank's own candidates (own_pos, own_rows, own_stats [k, 3], own_dec
// [5, k]) and pos_edge, and writes the exchange `xbuf`; phase 2 reads the
// all-reduced xbuf and the state and writes the state, the trip (in the
// scratch) and rank_part [6]; phase 3 reads parts [n_ranks, 6] and writes
// trip[2..3].
#define MC2_STEP_BLOCK_ENTRY(NAME, T)                                                   \
  int NAME(const void* counts, int d, const void* mags, const void* selfdot,            \
           const void* lens, const void* stddevs, const void* order, const void* cand,  \
           long long n_cand, double pos_edge, double margin, double tie_margin,         \
           long long maxc, void* alive, void* assign, void* astep, void* members,       \
           void* msum, const void* cur_d, long long cid, long long stepc,               \
           long long mcnt, void* scratch, long long scratch_len, long long n,           \
           long long row_lo, long long row_hi, int phase, const void* own_pos,          \
           const void* own_rows, long long n_own, const void* own_stats,                \
           const void* own_dec, void* xbuf, long long xbuf_len, int rank, int n_ranks,  \
           void* rank_part, const void* parts, int tie, void* stream) {                 \
    StepArgs a{};                                                                       \
    a.counts = counts;                                                                  \
    a.d = d;                                                                            \
    a.mags = static_cast<const double*>(mags);                                          \
    a.selfdot = static_cast<const double*>(selfdot);                                    \
    a.lens = static_cast<const double*>(lens);                                          \
    a.stddevs = static_cast<const double*>(stddevs);                                    \
    a.order = static_cast<const long long*>(order);                                     \
    a.cand = static_cast<const long long*>(cand);                                       \
    a.n_cand = n_cand;                                                                  \
    a.pos_edge = pos_edge;                                                              \
    a.margin = margin;                                                                  \
    a.tie_margin = tie_margin;                                                          \
    a.maxc = maxc;                                                                      \
    a.alive = static_cast<unsigned char*>(alive);                                       \
    a.assign = static_cast<long long*>(assign);                                         \
    a.astep = static_cast<long long*>(astep);                                           \
    a.members = static_cast<long long*>(members);                                       \
    a.msum = static_cast<long long*>(msum);                                             \
    a.cur_d = static_cast<const long long*>(cur_d);                                     \
    a.cid = cid;                                                                        \
    a.stepc = stepc;                                                                    \
    a.mcnt = mcnt;                                                                      \
    a.scratch = static_cast<long long*>(scratch);                                       \
    a.n = n;                                                                            \
    a.row_lo = row_lo;                                                                  \
    a.row_hi = row_hi;                                                                  \
    a.phase = phase;                                                                    \
    a.own_pos = static_cast<const long long*>(own_pos);                                 \
    a.own_rows = static_cast<const long long*>(own_rows);                               \
    a.n_own = n_own;                                                                    \
    a.own_stats = static_cast<const long long*>(own_stats);                             \
    a.own_dec = static_cast<const double*>(own_dec);                                    \
    a.xbuf = static_cast<long long*>(xbuf);                                             \
    a.rank = rank;                                                                      \
    a.n_ranks = n_ranks;                                                                \
    a.rank_part = static_cast<long long*>(rank_part);                                   \
    a.parts = static_cast<const long long*>(parts);                                     \
    a.tie = tie;                                                                        \
    return launch_block<T>(a, scratch_len, xbuf_len, stream);                           \
  }

MC2_STEP_BLOCK_ENTRY(mc2_window_step_block_u8, uint8_t)
MC2_STEP_BLOCK_ENTRY(mc2_window_step_block_u16, uint16_t)

#undef MC2_STEP_BLOCK_ENTRY

}  // extern "C"
