// The plane singles of pairs of rows of a device-resident k-mer histogram
// store, in float64, each with an absolute error bound.
//
// For each pair p, with rows a = a_idx[p] and b = b_idx[p] (b = b_idx[0] for
// every p in the center form), and each selected single j (the model's
// plane singles, model/classifier.py:PLANE_SINGLES, in model order):
//   out[j][p]       = the single's raw value, in the reference's (a, b)
//                     argument order (features/host.py),
//   out[S + j][p]   = a bound on |that value - the host oracle's|,
// S the number of selected singles.  The per-row planes and the log tables
// come from the host in float64 (ops/device_features.py:
// TorchDeviceFeatureEngine), each entry the very intermediate the host
// oracle forms for that row, so the bounds cover this kernel's own sums and
// roundings only:
//   markov      1/2 [sum_i (A_i - 1)(log B_i - log GB_g(i))
//                    + sum_i (B_i - 1)(log A_i - log GA_g(i))], G the groups
//               of 4 consecutive counts; log c and the log of a group sum
//               from two tables indexed by the integer (numpy's own logs,
//               equal bit for bit to the host's, checked at the build);
//   sim_mm      1 - exp(1/2 [log(mk / ms_b) / rm_b + log(mk / ms_a) / rm_a]),
//               mk the markov value, ms a row's markov with itself, rm its
//               real magnitude;
//   rre_k_r     from the two rows' groups of 4, the log of each relative
//               entropy term's ratio as one division of exact integer
//               products, 2 x sq / (x sq + y sp);
//   spearman    1 - cov / (sqrt(ss_a) sqrt(ss_b)) over the rows' rank
//               deviations, stored as 2 dev (integers, int16 up to D =
//               16,384): cov is an exact integer sum over 4, the host's
//               value bit for bit (a bound of 8 u (|r| + 1) covers square
//               roots that a library does not round correctly, r the ratio);
//   d2s         sum_i h_a h_b / hypot(h_a, h_b), h = counts - expectation;
//   d2_star     sum_i h_a h_b / ((rm_sum pq1_i + 1) sqrt(rm_a rm_b)), pq1_i
//               the product of the k combined one-mer probabilities of i's
//               digits, formed per pair in the host's order;
//   afd         (k = 2) sum_i (d_i (1 + d_i)^-14)^2, d_i = |A_i / oA_i/4 -
//               B_i / oB_i/4|;
//   n2r, n2rc, n2rrc  the dot of the rows' n2 z-planes.
// Each sum's bound is (D + 64) u times the sum of its terms' absolute values
// (either side's sum of D terms in any order, u = 2^-53) plus 16 u times a
// companion sum that covers the roundings where a term is not formed as the
// host forms it (a log, exp, pow or hypot of the CUDA math library): the
// ops/pair_stats.py:vector_singles_ref recipe.  Where a term is the host's
// bit for bit (the products of planes), the companion is |terms| itself.
// Every value rounding that the host repeats is an explicitly rounded
// intrinsic, so that nvcc contracts nothing into an FMA there.
//
// Replaces the plane branches of meshclust2_tpu/ops/device_features.py:
// DeviceFeatureEngine._build_pair_fn.pair_singles (l. 278-303, 306-316,
// 332-338, 344-376, 395-399), an XLA program that the JAX package runs in
// float32 behind host re-checks.
//
// What bounds it on an H100: float64 instructions (markov's and rre_k_r's
// per-element work, rre_k_r's two logs an element), or for the h and n2
// planes the bytes of two float64 rows a pair (a 10,000-row pool's plane
// is 82 MB and does not stay in the 50 MB L2).  The design:
//   - a team of S warps takes a pair, S doubled while the pairs' warps fit
//     one wave of the resident warps (S = 1 for an update batch of ~10^5
//     pairs, 2 for a 10k accumulate window of ~1,600), thread t of the team
//     the groups of 4 counts t, t + 32 S, ...; the team's partial sums meet
//     by xor butterflies and, for S > 1, in shared memory behind a named
//     barrier of the team; three blocks an SM (80 registers);
//   - the singles run in families that share their element work (markov and
//     sim_mm; rre_k_r; spearman; d2s and d2_star; afd; the n2 dots), one
//     family after the other, each with only its own sums live: the
//     registers are the largest family's, not the sum of all;
//   - a block stages the center row (its counts and every plane the
//     families read) in shared memory once, and for uint8 counts the two
//     log tables (256 + 1,021 float64); uint16 tables (65,536 + 262,141)
//     are read through L2;
//   - what a pair reads from device memory stays small: markov and rre_k_r
//     read the two count rows (2 KB at D = 1,024 uint8) and the tables,
//     spearman two int16 rows (4 KB); only d2s, d2_star and the n2 dots
//     read float64 rows.
//
// An index outside [0, n_rows) writes NaN into its pair's values and
// bounds; callers validate indices before launch.
//
// Built by nvcc for sm_90a (ops/_build.py) and bound through ctypes: the
// entry points launch on the given stream, allocate nothing, do not
// synchronise and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpSize = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarpSize * kWarps;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxCodes = 10;
constexpr int kMaxSplit = kWarps;   // a team is at most a block
constexpr int kMaxSums = 6;         // the largest family's sums
// the codes of model/classifier.py:SINGLE_CODES (csrc/pair_stats.cu enum
// Single): the plane singles follow the 23 others
enum Single {
  kMarkov = 23, kSimMm, kRreKR, kSpearman, kD2s, kD2Star, kAfd, kN2r, kN2rc, kN2rrc,
};
// singles that share their per-element work and sums
enum Family { kFamMarkov = 0, kFamRre, kFamSpearman, kFamH, kFamAfd, kFamN2 };

__host__ __device__ constexpr int family_of(int code) {
  return code <= kSimMm      ? kFamMarkov
         : code == kRreKR    ? kFamRre
         : code == kSpearman ? kFamSpearman
         : code <= kD2Star   ? kFamH
         : code == kAfd      ? kFamAfd
                             : kFamN2;
}

// uint8 log tables, staged in shared memory: log c for c < 256, then the
// log of a group sum up to 4 x 255
constexpr int kLogLenU8 = 256;
constexpr int kGroupLenU8 = 4 * 255 + 1;

struct Args {
  const void* counts;
  long long n_rows;
  int d;
  int k;
  const long long* a_idx;
  const long long* b_idx;
  long long n_pairs;
  int center;                 // 1: b_idx holds one index, the second row of every pair
  const double* mags;         // [N] count sums
  const double* real_mags;    // [N] mags - D
  const double* one_mers;     // [N, 4]
  const double* log_count;    // [L] log c (L = 256 uint8, 65,536 uint16)
  const double* log_group;    // [4 (L - 1) + 1] log of a group sum
  const double* markov_self;  // [N]
  const void* rank2;          // [N, D] int16 (int32 when rank_wide): 2 (tied rank - (D + 1) / 2)
  int rank_wide;
  const double* rank_ss;      // [N]
  const double* h;            // [N, D]
  const double* n2[3];        // [N, D] each: n2r, n2rc, n2rrc
  int slot[kMaxCodes];        // output row of single kMarkov + c; -1: not selected
  int n_codes;
  unsigned families;          // bit f: family f has a selected single
  int split;                  // S, warps a pair
  int stage;                  // 1: the center row is staged in shared memory
  int tables_shared;          // 1: the uint8 log tables are staged in shared memory
  double* out;                // [2, n_codes, P]
};

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int delta = kWarpSize / 2; delta > 0; delta >>= 1)
    v += __shfl_xor_sync(kFullMask, v, delta);
  return v;
}

__device__ __forceinline__ long long warp_sum_ll(long long v) {
#pragma unroll
  for (int delta = kWarpSize / 2; delta > 0; delta >>= 1)
    v += __shfl_xor_sync(kFullMask, v, delta);
  return v;
}

// The S warps that take one pair: their slots of the block's scratch and
// their named barrier.
struct Team {
  long long* scratch;   // [S][kMaxSums], this team's
  int split;
  int warp;             // the warp's rank in the team
  int lane;
  int bar;              // named barrier id (1 + the team's rank in the block)

  __device__ __forceinline__ void sync() const {
    if (split == 1) {
      __syncwarp();
    } else {
      asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(split * kWarpSize) : "memory");
    }
  }

  // The team's totals of v, the same bits on every thread: each warp's
  // butterfly, then the warps' parts added in warp order.
  template <int N>
  __device__ __forceinline__ void sum(double (&v)[N]) const {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = warp_sum(v[i]);
    if (split == 1) return;
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < N; ++i) scratch[warp * kMaxSums + i] = __double_as_longlong(v[i]);
    }
    sync();
#pragma unroll
    for (int i = 0; i < N; ++i) {
      double s = __longlong_as_double(scratch[i]);
      for (int w = 1; w < split; ++w) s += __longlong_as_double(scratch[w * kMaxSums + i]);
      v[i] = s;
    }
    sync();   // the scratch is free again
  }

  __device__ __forceinline__ long long sum_ll(long long v) const {
    v = warp_sum_ll(v);
    if (split == 1) return v;
    if (lane == 0) scratch[warp * kMaxSums] = v;
    sync();
    long long s = scratch[0];
    for (int w = 1; w < split; ++w) s += scratch[w * kMaxSums];
    sync();
    return s;
  }
};

// One side of a pair: its counts and plane rows (global memory, or the
// staged center row) and its row index for the per-row scalars.
template <typename T>
struct Row {
  const T* c;
  const void* rank;
  const double* h;
  const double* n2[3];
  long long r;
};

template <typename T>
__device__ __forceinline__ Row<T> row_at(const Args& g, long long r) {
  Row<T> w;
  const long long off = r * g.d;
  w.r = r;
  w.c = static_cast<const T*>(g.counts) + off;
  w.rank = g.rank2 ? static_cast<const char*>(g.rank2) + off * (g.rank_wide ? 4 : 2) : nullptr;
  w.h = g.h ? g.h + off : nullptr;
#pragma unroll
  for (int j = 0; j < 3; ++j) w.n2[j] = g.n2[j] ? g.n2[j] + off : nullptr;
  return w;
}

// The 4 counts of group q (16-byte aligned rows: one 4- or 8-byte load).
template <typename T>
__device__ __forceinline__ void load4(const T* row, int q, unsigned (&x)[4]) {
  if constexpr (sizeof(T) == 1) {
    const unsigned w = *reinterpret_cast<const unsigned*>(row + 4 * q);
    x[0] = w & 0xffu;
    x[1] = (w >> 8) & 0xffu;
    x[2] = (w >> 16) & 0xffu;
    x[3] = w >> 24;
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(row + 4 * q);
    x[0] = w.x & 0xffffu;
    x[1] = w.x >> 16;
    x[2] = w.y & 0xffffu;
    x[3] = w.y >> 16;
  }
}

__device__ __forceinline__ void load4d(const double* row, int q, double (&x)[4]) {
  const double2 u = reinterpret_cast<const double2*>(row)[2 * q];
  const double2 v = reinterpret_cast<const double2*>(row)[2 * q + 1];
  x[0] = u.x;
  x[1] = u.y;
  x[2] = v.x;
  x[3] = v.y;
}

// What a family's pass needs: the pair's two sides, the log tables, the
// thread's place in its team and where the pair's outputs go.
template <typename T>
struct Ctx {
  const Args* g;
  Row<T> a, b;
  const double* lt;   // log c
  const double* lg;   // log of a group sum
  int t, nt;          // thread in the team, the team's threads
  long long p;
};

__device__ __forceinline__ void put(const Args& g, int code, long long p, double v, double e) {
  const int j = g.slot[code - kMarkov];
  if (j < 0) return;
  g.out[j * g.n_pairs + p] = v;
  g.out[(g.n_codes + j) * g.n_pairs + p] = e;
}

constexpr double kU = 1.0 / 9007199254740992.0;   // 2^-53

// markov and sim_mm: sums (A - 1)(log B - log GB), (B - 1)(log A - log GA),
// |terms|, companion.
template <typename T>
__device__ __forceinline__ void fam_markov(const Ctx<T>& c, const Team& tm) {
  const Args& g = *c.g;
  double s[4] = {0.0, 0.0, 0.0, 0.0};
  for (int q = c.t; q < g.d / 4; q += c.nt) {
    unsigned x[4], y[4];
    load4(c.a.c, q, x);
    load4(c.b.c, q, y);
    const double ga = c.lg[x[0] + x[1] + x[2] + x[3]];
    const double gb = c.lg[y[0] + y[1] + y[2] + y[3]];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const double xm = __dsub_rn(static_cast<double>(x[j]), 1.0);   // exact
      const double ym = __dsub_rn(static_cast<double>(y[j]), 1.0);
      const double la = c.lt[x[j]], lb = c.lt[y[j]];
      const double t1 = __dmul_rn(xm, __dsub_rn(lb, gb));
      const double t2 = __dmul_rn(ym, __dsub_rn(la, ga));
      s[0] = __dadd_rn(s[0], t1);
      s[1] = __dadd_rn(s[1], t2);
      s[2] += fabs(t1) + fabs(t2);
      s[3] += xm * (fabs(lb) + fabs(gb)) + ym * (fabs(la) + fabs(ga));
    }
  }
  tm.sum(s);
  if (c.t != 0) return;
  const double hs = (static_cast<double>(g.d) + 64.0) * kU, e16 = 16.0 * kU;
  const double mk = __dmul_rn(0.5, __dadd_rn(s[0], s[1]));
  const double mk_err = 0.5 * (hs * s[2] + e16 * s[3]);
  put(g, kMarkov, c.p, mk, mk_err);
  if (g.slot[kSimMm - kMarkov] < 0) return;
  const long long ra = c.a.r, rb = c.b.r;
  const double rma = g.real_mags[ra], rmb = g.real_mags[rb];
  const double la = log(__ddiv_rn(mk, g.markov_self[ra]));
  const double lb = log(__ddiv_rn(mk, g.markov_self[rb]));
  const double d_ab = __ddiv_rn(lb, rmb), d_ba = __ddiv_rn(la, rma);
  const double xx = __dmul_rn(0.5, __dadd_rn(d_ab, d_ba));
  const double ex = exp(xx);
  const double v = __dsub_rn(1.0, ex);
  // first order: mk's relative error moves each log by as much
  const double em = mk_err / fabs(mk);
  const double ea = (1.5 * em + 4.0 * kU + 16.0 * kU * fabs(la)) / rma + 4.0 * kU * fabs(d_ba);
  const double eb = (1.5 * em + 4.0 * kU + 16.0 * kU * fabs(lb)) / rmb + 4.0 * kU * fabs(d_ab);
  const double exx = 0.5 * (ea + eb) + 4.0 * kU * fabs(xx);
  const double e = 2.0 * ex * exx + 16.0 * kU * (ex + fabs(v));
  put(g, kSimMm, c.p, v,
      em < 0.25 && isfinite(e) ? e : __longlong_as_double(0x7ff0000000000000LL));
}

// rre_k_r: cp / avg = 2 x sq / (x sq + y sp), exact integer products
// (< 2^36), rounded once; sums of both sides, |terms|, companion.
template <typename T>
__device__ __forceinline__ void fam_rre(const Ctx<T>& c, const Team& tm) {
  const Args& g = *c.g;
  double s[4] = {0.0, 0.0, 0.0, 0.0};
  for (int q = c.t; q < g.d / 4; q += c.nt) {
    unsigned xu[4], yu[4];
    load4(c.a.c, q, xu);
    load4(c.b.c, q, yu);
    const double sp = static_cast<double>(xu[0] + xu[1] + xu[2] + xu[3]);   // exact
    const double sq = static_cast<double>(yu[0] + yu[1] + yu[2] + yu[3]);
    // the companion's shares x / sp, y / sq may round freely
    const double isp = 1.0 / sp, isq = 1.0 / sq;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const double x = xu[j], y = yu[j];
      const double den = __dadd_rn(__dmul_rn(x, sq), __dmul_rn(y, sp));
      const double lp = log(__ddiv_rn(__dmul_rn(__dmul_rn(2.0, x), sq), den));
      const double lq = log(__ddiv_rn(__dmul_rn(__dmul_rn(2.0, y), sp), den));
      const double tp = __ddiv_rn(__dmul_rn(x, lp), sp);
      const double tq = __ddiv_rn(__dmul_rn(y, lq), sq);
      s[0] = __dadd_rn(s[0], tp);
      s[1] = __dadd_rn(s[1], tq);
      s[2] += fabs(tp) + fabs(tq);
      s[3] += x * isp * (fabs(lp) + 1.0) + y * isq * (fabs(lq) + 1.0);
    }
  }
  tm.sum(s);
  if (c.t != 0) return;
  const double hs = (static_cast<double>(g.d) + 64.0) * kU, e16 = 16.0 * kU;
  put(g, kRreKR, c.p, __dmul_rn(0.5, __dadd_rn(s[0], s[1])), 0.5 * (hs * s[2] + e16 * s[3]));
}

// spearman: the exact integer sum of (2 dev_a)(2 dev_b).
template <typename T>
__device__ __forceinline__ void fam_spearman(const Ctx<T>& c, const Team& tm) {
  const Args& g = *c.g;
  long long acc = 0;
  for (int q = c.t; q < g.d / 4; q += c.nt) {
    if (g.rank_wide) {
      const int4 u = static_cast<const int4*>(c.a.rank)[q];
      const int4 v = static_cast<const int4*>(c.b.rank)[q];
      acc += static_cast<long long>(u.x) * v.x + static_cast<long long>(u.y) * v.y +
             static_cast<long long>(u.z) * v.z + static_cast<long long>(u.w) * v.w;
    } else {
      // |2 dev| < 2^14: each product < 2^28, four of them < 2^30
      const short4 u = static_cast<const short4*>(c.a.rank)[q];
      const short4 v = static_cast<const short4*>(c.b.rank)[q];
      acc += u.x * v.x + u.y * v.y + u.z * v.z + u.w * v.w;
    }
  }
  acc = tm.sum_ll(acc);
  if (c.t != 0) return;
  const double cov = __dmul_rn(__ll2double_rn(acc), 0.25);   // exact: the host's cov
  const double r = __ddiv_rn(cov, __dmul_rn(__dsqrt_rn(g.rank_ss[c.a.r]),
                                            __dsqrt_rn(g.rank_ss[c.b.r])));
  put(g, kSpearman, c.p, __dsub_rn(1.0, r), 8.0 * kU * (fabs(r) + 1.0));
}

// d2s and d2_star over the h planes.
template <typename T>
__device__ __forceinline__ void fam_h(const Ctx<T>& c, const Team& tm) {
  const Args& g = *c.g;
  const bool with_s = g.slot[kD2s - kMarkov] >= 0, with_star = g.slot[kD2Star - kMarkov] >= 0;
  const long long ra = c.a.r, rb = c.b.r;
  // d_star: the combined one-mer probabilities (oA + oB) / (mA + mB), the
  // real magnitudes' sum and sqrt(rm_a rm_b), as the host forms them
  double cm[4] = {0.0, 0.0, 0.0, 0.0};
  double rm_sum = 0.0, pq_len = 0.0;
  if (with_star) {
    const double msum = __dadd_rn(g.mags[ra], g.mags[rb]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      cm[i] = __ddiv_rn(__dadd_rn(g.one_mers[4 * ra + i], g.one_mers[4 * rb + i]), msum);
    rm_sum = __dadd_rn(g.real_mags[ra], g.real_mags[rb]);
    pq_len = __dsqrt_rn(__dmul_rn(g.real_mags[ra], g.real_mags[rb]));
  }
  double s[4] = {0.0, 0.0, 0.0, 0.0};   // d2s, |d2s terms|, d2_star, |d2_star terms|
  for (int q = c.t; q < g.d / 4; q += c.nt) {
    double hp[4], hq[4];
    load4d(c.a.h, q, hp);
    load4d(c.b.h, q, hq);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const double num = __dmul_rn(hp[j], hq[j]);
      if (with_s) {
        const double den = hypot(hp[j], hq[j]);
        const double t = den != 0.0 ? __ddiv_rn(num, den) : 0.0;
        s[0] = __dadd_rn(s[0], t);
        s[1] += fabs(t);
      }
      if (with_star) {
        // the product over i's digits, least significant first, in order
        const int i = 4 * q + j;
        double pq1 = cm[j];
        for (int e = 1; e < g.k; ++e) pq1 = __dmul_rn(pq1, cm[(i >> (2 * e)) & 3]);
        const double den = __dmul_rn(__dadd_rn(__dmul_rn(rm_sum, pq1), 1.0), pq_len);
        const double t = den > 0.0 ? __ddiv_rn(num, den) : 0.0;
        s[2] = __dadd_rn(s[2], t);
        s[3] += fabs(t);
      }
    }
  }
  tm.sum(s);
  if (c.t != 0) return;
  const double hs = (static_cast<double>(g.d) + 64.0) * kU, e16 = 16.0 * kU;
  put(g, kD2s, c.p, s[0], (hs + e16) * s[1]);
  put(g, kD2Star, c.p, s[2], (hs + e16) * s[3]);
}

// n2r, n2rc, n2rrc: the dots of the z-planes, and |terms|.
template <typename T>
__device__ __forceinline__ void fam_n2(const Ctx<T>& c, const Team& tm) {
  const Args& g = *c.g;
  bool on[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) on[j] = g.slot[kN2r + j - kMarkov] >= 0;
  double s[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int q = c.t; q < g.d / 4; q += c.nt) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (!on[j]) continue;
      double za[4], zb[4];
      load4d(c.a.n2[j], q, za);
      load4d(c.b.n2[j], q, zb);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const double t = __dmul_rn(za[e], zb[e]);
        s[2 * j] = __dadd_rn(s[2 * j], t);
        s[2 * j + 1] += fabs(t);
      }
    }
  }
  tm.sum(s);
  if (c.t != 0) return;
  const double hs = (static_cast<double>(g.d) + 64.0) * kU, e16 = 16.0 * kU;
#pragma unroll
  for (int j = 0; j < 3; ++j) put(g, kN2r + j, c.p, s[2 * j], (hs + e16) * s[2 * j + 1]);
}

// afd (D = 16): sum of (d (1 + d)^-14)^2.
template <typename T>
__device__ __forceinline__ void fam_afd(const Ctx<T>& c, const Team& tm) {
  const Args& g = *c.g;
  double s[1] = {0.0};
  for (int q = c.t; q < g.d / 4; q += c.nt) {
    unsigned x[4], y[4];
    load4(c.a.c, q, x);
    load4(c.b.c, q, y);
    const double oa = g.one_mers[4 * c.a.r + q], ob = g.one_mers[4 * c.b.r + q];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const double xr = __ddiv_rn(static_cast<double>(x[j]), oa);
      const double yr = __ddiv_rn(static_cast<double>(y[j]), ob);
      const double df = fabs(__dsub_rn(xr, yr));
      const double un = __dmul_rn(df, pow(__dadd_rn(1.0, df), -14.0));
      s[0] = __dadd_rn(s[0], __dmul_rn(un, un));
    }
  }
  tm.sum(s);
  if (c.t != 0) return;
  const double hs = (static_cast<double>(g.d) + 64.0) * kU, e16 = 16.0 * kU;
  put(g, kAfd, c.p, s[0], (hs + 4.0 * e16) * s[0]);
}

__host__ __device__ constexpr int round16(long long bytes) {
  return static_cast<int>((bytes + 15) / 16 * 16);
}

// Shared memory: the uint8 log tables, then the staged center row (counts,
// ranks, h, the n2 planes, each only if a family reads it), then the
// teams' scratch.
struct Layout {
  int tables, counts, rank, h, n2[3], scratch, total;
};

template <typename T>
__host__ __device__ Layout layout(const Args& g) {
  Layout l{};
  int off = 0;
  l.tables = off;
  if (g.tables_shared) off += round16(8LL * (kLogLenU8 + kGroupLenU8));
  const unsigned f = g.families;
  const bool counts = f & ((1u << kFamMarkov) | (1u << kFamRre) | (1u << kFamAfd));
  l.counts = off;
  if (g.stage && counts) off += round16(static_cast<long long>(g.d) * sizeof(T));
  l.rank = off;
  if (g.stage && (f & (1u << kFamSpearman)))
    off += round16(static_cast<long long>(g.d) * (g.rank_wide ? 4 : 2));
  l.h = off;
  if (g.stage && (f & (1u << kFamH))) off += round16(8LL * g.d);
  for (int j = 0; j < 3; ++j) {
    l.n2[j] = off;
    if (g.stage && g.slot[kN2r + j - kMarkov] >= 0) off += round16(8LL * g.d);
  }
  l.scratch = off;
  off += 8 * kWarps * kMaxSums;
  l.total = off;
  return l;
}

// copy a row of `bytes` (a multiple of 4) from global to shared memory, the
// block together: 16 bytes a thread where the row allows it
__device__ __forceinline__ void stage(void* dst, const void* src, int bytes) {
  if (bytes % 16 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const uint4* s = static_cast<const uint4*>(src);
    uint4* t = static_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < bytes / 16; i += kThreads) t[i] = s[i];
  } else {
    const unsigned* s = static_cast<const unsigned*>(src);
    unsigned* t = static_cast<unsigned*>(dst);
    for (int i = threadIdx.x; i < bytes / 4; i += kThreads) t[i] = s[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 3) plane_singles_kernel(const Args g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = layout<T>(g);
  const int warp = threadIdx.x / kWarpSize;
  const int split = g.split;
  const int teams = kWarps / split;
  const int team = warp / split;
  const int nt = split * kWarpSize;
  const int t = threadIdx.x - team * nt;
  const double* lt = g.log_count;
  const double* lg = g.log_group;
  if (g.tables_shared) {
    double* s = reinterpret_cast<double*>(smem + l.tables);
    for (int i = threadIdx.x; i < kLogLenU8 + kGroupLenU8; i += kThreads)
      s[i] = i < kLogLenU8 ? g.log_count[i] : g.log_group[i - kLogLenU8];
    lt = s;
    lg = s + kLogLenU8;
  }
  bool c_ok = true;
  Row<T> crow{};
  if (g.center) {
    const long long r = g.b_idx[0];
    c_ok = r >= 0 && r < g.n_rows;
    if (c_ok) {
      crow = row_at<T>(g, r);
      if (g.stage) {
        const unsigned f = g.families;
        if (f & ((1u << kFamMarkov) | (1u << kFamRre) | (1u << kFamAfd))) {
          stage(smem + l.counts, crow.c, g.d * static_cast<int>(sizeof(T)));
          crow.c = reinterpret_cast<const T*>(smem + l.counts);
        }
        if (f & (1u << kFamSpearman)) {
          stage(smem + l.rank, crow.rank, g.d * (g.rank_wide ? 4 : 2));
          crow.rank = smem + l.rank;
        }
        if (f & (1u << kFamH)) {
          stage(smem + l.h, crow.h, 8 * g.d);
          crow.h = reinterpret_cast<const double*>(smem + l.h);
        }
        for (int j = 0; j < 3; ++j) {
          if (g.slot[kN2r + j - kMarkov] < 0) continue;
          stage(smem + l.n2[j], crow.n2[j], 8 * g.d);
          crow.n2[j] = reinterpret_cast<const double*>(smem + l.n2[j]);
        }
      }
    }
  }
  const Team tm{reinterpret_cast<long long*>(smem + l.scratch) + team * split * kMaxSums, split,
                warp - team * split, static_cast<int>(threadIdx.x % kWarpSize), 1 + team};
  __syncthreads();
  const long long n = g.n_pairs;
  for (long long p = static_cast<long long>(blockIdx.x) * teams + team; p < n;
       p += static_cast<long long>(gridDim.x) * teams) {
    const long long ra = g.a_idx[p];
    const long long rb = g.center ? crow.r : g.b_idx[p];
    const bool ok = ra >= 0 && ra < g.n_rows && (g.center ? c_ok : rb >= 0 && rb < g.n_rows);
    if (!ok) {   // uniform across the team
      if (t == 0) {
        const double nan = __longlong_as_double(0x7ff8000000000000LL);
        for (int j = 0; j < g.n_codes; ++j) {
          g.out[j * n + p] = nan;
          g.out[(g.n_codes + j) * n + p] = nan;
        }
      }
      continue;
    }
    const Ctx<T> c{&g, row_at<T>(g, ra), g.center ? crow : row_at<T>(g, rb), lt, lg, t, nt, p};
    const unsigned f = g.families;
    if (f & (1u << kFamMarkov)) fam_markov(c, tm);
    if (f & (1u << kFamRre)) fam_rre(c, tm);
    if (f & (1u << kFamSpearman)) fam_spearman(c, tm);
    if (f & (1u << kFamH)) fam_h(c, tm);
    if (f & (1u << kFamAfd)) fam_afd(c, tm);
    if (f & (1u << kFamN2)) fam_n2(c, tm);
  }
}

int device_attr(cudaDeviceAttr attr, int fallback) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&v, attr, dev) != cudaSuccess ||
      v <= 0)
    return fallback;
  return v;
}

template <typename T>
int launch(const void* counts, long long n_rows, int d, int k, const void* a_idx,
           const void* b_idx, int center, long long n_pairs, const void* mags,
           const void* real_mags, const void* one_mers, const void* log_count,
           const void* log_group, const void* markov_self, const void* rank2, int rank_wide,
           const void* rank_ss, const void* h, const void* n2r, const void* n2rc,
           const void* n2rrc, const int* codes, int n_codes, void* out, void* stream) {
  if (n_pairs <= 0) return static_cast<int>(cudaSuccess);
  if (d <= 0 || d % 4 != 0 || n_codes <= 0 || n_codes > kMaxCodes ||
      reinterpret_cast<uintptr_t>(counts) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args g{};
  g.counts = counts;
  g.n_rows = n_rows;
  g.d = d;
  g.k = k;
  g.a_idx = static_cast<const long long*>(a_idx);
  g.b_idx = static_cast<const long long*>(b_idx);
  g.n_pairs = n_pairs;
  g.center = center;
  g.mags = static_cast<const double*>(mags);
  g.real_mags = static_cast<const double*>(real_mags);
  g.one_mers = static_cast<const double*>(one_mers);
  g.log_count = static_cast<const double*>(log_count);
  g.log_group = static_cast<const double*>(log_group);
  g.markov_self = static_cast<const double*>(markov_self);
  g.rank2 = rank2;
  g.rank_wide = rank_wide;
  g.rank_ss = static_cast<const double*>(rank_ss);
  g.h = static_cast<const double*>(h);
  g.n2[0] = static_cast<const double*>(n2r);
  g.n2[1] = static_cast<const double*>(n2rc);
  g.n2[2] = static_cast<const double*>(n2rrc);
  g.n_codes = n_codes;
  g.out = static_cast<double*>(out);
  for (int j = 0; j < kMaxCodes; ++j) g.slot[j] = -1;
  for (int j = 0; j < n_codes; ++j) {
    const int c = codes[j];
    if (c < kMarkov || c > kN2rrc || g.slot[c - kMarkov] >= 0)
      return static_cast<int>(cudaErrorInvalidValue);
    g.slot[c - kMarkov] = j;
    g.families |= 1u << family_of(c);
  }
  // every plane a selected single reads, 16-byte aligned
  auto sel = [&](int c) { return g.slot[c - kMarkov] >= 0; };
  auto bad = [](const void* ptr) { return !ptr || reinterpret_cast<uintptr_t>(ptr) % 16 != 0; };
  if (((sel(kMarkov) || sel(kSimMm)) && (bad(log_count) || bad(log_group))) ||
      (sel(kSimMm) && !markov_self) || (sel(kSpearman) && (bad(rank2) || !rank_ss)) ||
      ((sel(kD2s) || sel(kD2Star)) && bad(h)) || (sel(kAfd) && d != 16) ||
      (sel(kN2r) && bad(n2r)) || (sel(kN2rc) && bad(n2rc)) || (sel(kN2rrc) && bad(n2rrc)))
    return static_cast<int>(cudaErrorInvalidValue);
  g.tables_shared = sizeof(T) == 1 && (g.families & (1u << kFamMarkov));
  g.split = 1;
  static const int optin = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, 48 * 1024);
  g.stage = center;
  if (layout<T>(g).total > optin) g.stage = 0;
  const int smem = layout<T>(g).total;
  auto kern = plane_singles_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  static const int sms = device_attr(cudaDevAttrMultiProcessorCount, 132);
  static int cached_smem = -1, per_sm = 0;
  if (smem != cached_smem) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    cached_smem = smem;
  }
  const long long resident = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  // S warps a pair: more while the pairs' warps still fit one wave of the
  // resident warps, as long as each thread keeps two groups of 4
  while (2 * g.split <= kMaxSplit && 2 * g.split * kWarpSize * 8 <= d &&
         2 * n_pairs * g.split <= resident * kWarps)
    g.split *= 2;
  const int teams = kWarps / g.split;
  const long long want = (n_pairs + teams - 1) / teams;
  const long long blocks = want < resident ? want : resident;
  kern<<<dim3(static_cast<unsigned>(blocks)), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out [2, n_codes, P] float64: the values, then their bounds, of the plane
// singles with `codes` (model/classifier.py:SINGLE_CODES; a host array),
// for pairs (a_idx[p], b_idx[p]) or (a_idx[p], b_idx[0]) when center = 1.
// Planes and tables that no selected single reads may be null; the counts
// and every plane read are 16-byte aligned.
int mc2_plane_singles_u8(const void* counts, long long n_rows, int d, int k, const void* a_idx,
                         const void* b_idx, int center, long long n_pairs, const void* mags,
                         const void* real_mags, const void* one_mers, const void* log_count,
                         const void* log_group, const void* markov_self, const void* rank2,
                         int rank_wide, const void* rank_ss, const void* h, const void* n2r,
                         const void* n2rc, const void* n2rrc, const int* codes, int n_codes,
                         void* out, void* stream) {
  return launch<uint8_t>(counts, n_rows, d, k, a_idx, b_idx, center, n_pairs, mags, real_mags,
                         one_mers, log_count, log_group, markov_self, rank2, rank_wide, rank_ss,
                         h, n2r, n2rc, n2rrc, codes, n_codes, out, stream);
}

int mc2_plane_singles_u16(const void* counts, long long n_rows, int d, int k, const void* a_idx,
                          const void* b_idx, int center, long long n_pairs, const void* mags,
                          const void* real_mags, const void* one_mers, const void* log_count,
                          const void* log_group, const void* markov_self, const void* rank2,
                          int rank_wide, const void* rank_ss, const void* h, const void* n2r,
                          const void* n2rc, const void* n2rrc, const int* codes, int n_codes,
                          void* out, void* stream) {
  return launch<uint16_t>(counts, n_rows, d, k, a_idx, b_idx, center, n_pairs, mags, real_mags,
                          one_mers, log_count, log_group, markov_self, rank2, rank_wide, rank_ss,
                          h, n2r, n2rc, n2rrc, codes, n_codes, out, stream);
}

}  // extern "C"
