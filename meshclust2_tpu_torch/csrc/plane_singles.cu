// The plane singles of pairs of rows of a device-resident k-mer histogram
// store, in float64, each with an absolute error bound.
//
// For each pair p, with rows a = a_idx[p] and b = b_idx[p] (b = b_idx[0] for
// every p in the center form), and each selected single j (the model's
// plane singles, model/classifier.py:PLANE_SINGLES, in model order):
//   out[j][p]       = the single's raw value, in the reference's (a, b)
//                     argument order (features/host.py),
//   out[S + j][p]   = a bound on |that value - the host oracle's|,
// S the number of selected singles.  The per-row planes come from the host
// in float64 (ops/device_features.py:TorchDeviceFeatureEngine), each entry
// the very intermediate the host oracle forms for that row, so the bounds
// cover this kernel's own sums and roundings only:
//   markov      1/2 [sum_i (A_i - 1)(log B_i - log GB_g(i))
//                    + sum_i (B_i - 1)(log A_i - log GA_g(i))], G the groups
//               of 4 consecutive counts (log counts and log group sums);
//   sim_mm      1 - exp(1/2 [log(mk / ms_b) / rm_b + log(mk / ms_a) / rm_a]),
//               mk the markov value, ms a row's markov with itself, rm its
//               real magnitude;
//   rre_k_r     from the two rows' groups of 4, the log of each relative
//               entropy term's ratio as one division of exact integer
//               products, 2 x sq / (x sq + y sp);
//   spearman    1 - cov / (sqrt(ss_a) sqrt(ss_b)) over the rows' rank
//               deviations: half-integers, so cov is exact in any order and
//               every operation here is the host's (a bound of 8 u (|r| + 1)
//               covers square roots that a library does not round correctly,
//               r the ratio);
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
// What bounds it on an H100: operations and bytes together.  A pair reads
// two float64 plane rows a single (2 x 8 KB at D = 1,024; the planes of a
// 10,000-row pool, 80 MB each, do not stay in the 50 MB L2) and does a few
// float64 operations an element, some of them a log, pow or hypot.  The
// design is the simple one: one warp a pair, lane l takes the elements
// l, l + 32, ... (coalesced), or the groups of 4 for rre_k_r, sums in
// float64 and the warp reduces by an xor butterfly; lane j then finishes
// single j.  A grid-stride loop over pairs.
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
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpSize * kWarpsPerBlock;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxCodes = 10;
// the codes of model/classifier.py:SINGLE_CODES (csrc/pair_stats.cu enum
// Single): the plane singles follow the 23 others
enum Single {
  kMarkov = 23, kSimMm, kRreKR, kSpearman, kD2s, kD2Star, kAfd, kN2r, kN2rc, kN2rrc,
};
__host__ __device__ constexpr unsigned bit(int code) { return 1u << (code - kMarkov); }

struct Args {
  const void* counts;
  long long n_rows;
  int d;
  int k;
  const long long* a_idx;
  const long long* b_idx;
  long long n_pairs;
  int center;              // 1: b_idx holds one index, the second row of every pair
  const double* mags;      // [N] count sums
  const double* real_mags; // [N] mags - D
  const double* one_mers;  // [N, 4]
  const double* log_counts;   // [N, D]
  const double* log_groups;   // [N, D / 4]
  const double* markov_self;  // [N]
  const double* rank_dev;     // [N, D]
  const double* rank_ss;      // [N]
  const double* h;            // [N, D]
  const double* n2[3];        // [N, D] each: n2r, n2rc, n2rrc
  int codes[kMaxCodes];
  int n_codes;
  unsigned mask;              // bit(code) of every selected code
  double* out;                // [2, n_codes, P]
};

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int delta = kWarpSize / 2; delta > 0; delta >>= 1)
    v += __shfl_xor_sync(kFullMask, v, delta);
  return v;
}

// A pair's sums over the two rows: lane parts, then (reduce) warp totals.
struct Sums {
  double m1, m2, m_abs, m_comp;   // markov: the two sides, |terms|, companion
  double rp, rq, r_abs, r_comp;   // rre_k_r
  double cov;                     // spearman
  double s2, s2_abs;              // d2s
  double st, st_abs;              // d2_star
  double afd;                     // afd (terms >= 0)
  double n2[3], n2_abs[3];        // n2r, n2rc, n2rrc
};

template <typename T>
__device__ __forceinline__ void lane_sums(const Args& g, long long ra, long long rb, int lane,
                                          Sums& s) {
  const int d = g.d;
  const unsigned m = g.mask;
  const T* ca = static_cast<const T*>(g.counts) + ra * d;
  const T* cb = static_cast<const T*>(g.counts) + rb * d;
  const long long oa = ra * d, ob = rb * d;
  const long long qa = ra * (d / 4), qb = rb * (d / 4);
  // d_star: the combined one-mer probabilities (oA + oB) / (mA + mB), the
  // real magnitudes' sum and sqrt(rm_a rm_b), as the host forms them
  double cm[4] = {0.0, 0.0, 0.0, 0.0};
  double rm_sum = 0.0, pq_len = 0.0;
  if (m & bit(kD2Star)) {
    const double msum = __dadd_rn(g.mags[ra], g.mags[rb]);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      cm[c] = __ddiv_rn(__dadd_rn(g.one_mers[4 * ra + c], g.one_mers[4 * rb + c]), msum);
    rm_sum = __dadd_rn(g.real_mags[ra], g.real_mags[rb]);
    pq_len = __dsqrt_rn(__dmul_rn(g.real_mags[ra], g.real_mags[rb]));
  }
  for (int i = lane; i < d; i += kWarpSize) {
    const double x = static_cast<double>(ca[i]);
    const double y = static_cast<double>(cb[i]);
    if (m & (bit(kMarkov) | bit(kSimMm))) {
      const double la = g.log_counts[oa + i], lb = g.log_counts[ob + i];
      const double ga = g.log_groups[qa + i / 4], gb = g.log_groups[qb + i / 4];
      const double xm = __dsub_rn(x, 1.0), ym = __dsub_rn(y, 1.0);   // exact
      const double t1 = __dmul_rn(xm, __dsub_rn(lb, gb));
      const double t2 = __dmul_rn(ym, __dsub_rn(la, ga));
      s.m1 = __dadd_rn(s.m1, t1);
      s.m2 = __dadd_rn(s.m2, t2);
      s.m_abs += fabs(t1) + fabs(t2);
      s.m_comp += xm * (fabs(lb) + fabs(gb)) + ym * (fabs(la) + fabs(ga));
    }
    if (m & bit(kSpearman))
      s.cov = __dadd_rn(s.cov, __dmul_rn(g.rank_dev[oa + i], g.rank_dev[ob + i]));
    if (m & (bit(kD2s) | bit(kD2Star))) {
      const double hp = g.h[oa + i], hq = g.h[ob + i];
      const double num = __dmul_rn(hp, hq);
      if (m & bit(kD2s)) {
        const double den = hypot(hp, hq);
        const double t = den != 0.0 ? __ddiv_rn(num, den) : 0.0;
        s.s2 = __dadd_rn(s.s2, t);
        s.s2_abs += fabs(t);
      }
      if (m & bit(kD2Star)) {
        // the product over i's digits, least significant first, in order
        double pq1 = cm[i & 3];
        for (int j = 1; j < g.k; ++j) pq1 = __dmul_rn(pq1, cm[(i >> (2 * j)) & 3]);
        const double den = __dmul_rn(__dadd_rn(__dmul_rn(rm_sum, pq1), 1.0), pq_len);
        const double t = den > 0.0 ? __ddiv_rn(num, den) : 0.0;
        s.st = __dadd_rn(s.st, t);
        s.st_abs += fabs(t);
      }
    }
    if (m & bit(kAfd)) {
      const double xr = __ddiv_rn(x, g.one_mers[4 * ra + i / 4]);
      const double yr = __ddiv_rn(y, g.one_mers[4 * rb + i / 4]);
      const double df = fabs(__dsub_rn(xr, yr));
      const double un = __dmul_rn(df, pow(__dadd_rn(1.0, df), -14.0));
      s.afd = __dadd_rn(s.afd, __dmul_rn(un, un));
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (m & bit(kN2r + j)) {
        const double t = __dmul_rn(g.n2[j][oa + i], g.n2[j][ob + i]);
        s.n2[j] = __dadd_rn(s.n2[j], t);
        s.n2_abs[j] += fabs(t);
      }
    }
  }
  if (m & bit(kRreKR)) {
    // groups g = lane, lane + 32, ...: cp / avg = 2 x sq / (x sq + y sp),
    // exact integer products (< 2^36), rounded once
    for (int q = lane; q < d / 4; q += kWarpSize) {
      double xs[4], ys[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        xs[j] = static_cast<double>(ca[4 * q + j]);
        ys[j] = static_cast<double>(cb[4 * q + j]);
      }
      const double sp = xs[0] + xs[1] + xs[2] + xs[3];   // exact integers
      const double sq = ys[0] + ys[1] + ys[2] + ys[3];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const double den = __dadd_rn(__dmul_rn(xs[j], sq), __dmul_rn(ys[j], sp));
        const double lp = log(__ddiv_rn(__dmul_rn(__dmul_rn(2.0, xs[j]), sq), den));
        const double lq = log(__ddiv_rn(__dmul_rn(__dmul_rn(2.0, ys[j]), sp), den));
        const double tp = __ddiv_rn(__dmul_rn(xs[j], lp), sp);
        const double tq = __ddiv_rn(__dmul_rn(ys[j], lq), sq);
        s.rp = __dadd_rn(s.rp, tp);
        s.rq = __dadd_rn(s.rq, tq);
        s.r_abs += fabs(tp) + fabs(tq);
        s.r_comp += xs[j] / sp * (fabs(lp) + 1.0) + ys[j] / sq * (fabs(lq) + 1.0);
      }
    }
  }
}

// The warp's totals of the selected sums, on every lane.
__device__ __forceinline__ void reduce(unsigned m, Sums& s) {
  if (m & (bit(kMarkov) | bit(kSimMm))) {
    s.m1 = warp_sum(s.m1);
    s.m2 = warp_sum(s.m2);
    s.m_abs = warp_sum(s.m_abs);
    s.m_comp = warp_sum(s.m_comp);
  }
  if (m & bit(kRreKR)) {
    s.rp = warp_sum(s.rp);
    s.rq = warp_sum(s.rq);
    s.r_abs = warp_sum(s.r_abs);
    s.r_comp = warp_sum(s.r_comp);
  }
  if (m & bit(kSpearman)) s.cov = warp_sum(s.cov);
  if (m & bit(kD2s)) {
    s.s2 = warp_sum(s.s2);
    s.s2_abs = warp_sum(s.s2_abs);
  }
  if (m & bit(kD2Star)) {
    s.st = warp_sum(s.st);
    s.st_abs = warp_sum(s.st_abs);
  }
  if (m & bit(kAfd)) s.afd = warp_sum(s.afd);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    if (m & bit(kN2r + j)) {
      s.n2[j] = warp_sum(s.n2[j]);
      s.n2_abs[j] = warp_sum(s.n2_abs[j]);
    }
  }
}

// Single `code` of the pair from the warp's totals, and into *err its
// bound: ops/plane_singles.py:_plane_terms, formula for formula.
__device__ __forceinline__ double finish(int code, const Args& g, long long ra, long long rb,
                                         const Sums& s, double* err) {
  constexpr double u = 1.0 / 9007199254740992.0;   // 2^-53
  const double hs = (static_cast<double>(g.d) + 64.0) * u, e16 = 16.0 * u;
  const double mk = __dmul_rn(0.5, __dadd_rn(s.m1, s.m2));
  const double mk_err = 0.5 * (hs * s.m_abs + e16 * s.m_comp);
  switch (code) {
    case kMarkov:
      *err = mk_err;
      return mk;
    case kSimMm: {
      const double rma = g.real_mags[ra], rmb = g.real_mags[rb];
      const double la = log(__ddiv_rn(mk, g.markov_self[ra]));
      const double lb = log(__ddiv_rn(mk, g.markov_self[rb]));
      const double d_ab = __ddiv_rn(lb, rmb), d_ba = __ddiv_rn(la, rma);
      const double x = __dmul_rn(0.5, __dadd_rn(d_ab, d_ba));
      const double ex = exp(x);
      const double v = __dsub_rn(1.0, ex);
      // first order: mk's relative error moves each log by as much
      const double em = mk_err / fabs(mk);
      const double ea = (1.5 * em + 4.0 * u + 16.0 * u * fabs(la)) / rma + 4.0 * u * fabs(d_ba);
      const double eb = (1.5 * em + 4.0 * u + 16.0 * u * fabs(lb)) / rmb + 4.0 * u * fabs(d_ab);
      const double exx = 0.5 * (ea + eb) + 4.0 * u * fabs(x);
      const double e = 2.0 * ex * exx + 16.0 * u * (ex + fabs(v));
      *err = em < 0.25 && isfinite(e) ? e : __longlong_as_double(0x7ff0000000000000LL);
      return v;
    }
    case kRreKR:
      *err = 0.5 * (hs * s.r_abs + e16 * s.r_comp);
      return __dmul_rn(0.5, __dadd_rn(s.rp, s.rq));
    case kSpearman: {
      const double r = __ddiv_rn(s.cov, __dmul_rn(__dsqrt_rn(g.rank_ss[ra]),
                                                  __dsqrt_rn(g.rank_ss[rb])));
      *err = 8.0 * u * (fabs(r) + 1.0);
      return __dsub_rn(1.0, r);
    }
    case kD2s:
      *err = (hs + e16) * s.s2_abs;
      return s.s2;
    case kD2Star:
      *err = (hs + e16) * s.st_abs;
      return s.st;
    case kAfd:
      *err = (hs + 4.0 * e16) * s.afd;
      return s.afd;
    case kN2r:
    case kN2rc:
    case kN2rrc:
      *err = (hs + e16) * s.n2_abs[code - kN2r];
      return s.n2[code - kN2r];
  }
  *err = 0.0;
  return __longlong_as_double(0x7ff8000000000000LL);   // unreachable: checked
}

template <typename T>
__global__ void __launch_bounds__(kThreads) plane_singles_kernel(const Args g) {
  const int lane = threadIdx.x % kWarpSize;
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / kWarpSize;
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarpsPerBlock;
  const long long n = g.n_pairs;
  for (long long p = warp; p < n; p += n_warps) {
    const long long ra = g.a_idx[p];
    const long long rb = g.center ? g.b_idx[0] : g.b_idx[p];
    if (ra < 0 || ra >= g.n_rows || rb < 0 || rb >= g.n_rows) {   // uniform
      if (lane < g.n_codes) {
        const double nan = __longlong_as_double(0x7ff8000000000000LL);
        g.out[lane * n + p] = nan;
        g.out[(g.n_codes + lane) * n + p] = nan;
      }
      continue;
    }
    Sums s{};
    lane_sums<T>(g, ra, rb, lane, s);
    reduce(g.mask, s);
    if (lane < g.n_codes) {
      double err = 0.0;
      const double v = finish(g.codes[lane], g, ra, rb, s, &err);
      g.out[lane * n + p] = v;
      g.out[(g.n_codes + lane) * n + p] = err;
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        sms <= 0)
      sms = 132;
  }
  return sms;
}

template <typename T>
int launch(const void* counts, long long n_rows, int d, int k, const void* a_idx,
           const void* b_idx, int center, long long n_pairs, const void* mags,
           const void* real_mags, const void* one_mers, const void* log_counts,
           const void* log_groups, const void* markov_self, const void* rank_dev,
           const void* rank_ss, const void* h, const void* n2r, const void* n2rc,
           const void* n2rrc, const int* codes, int n_codes, void* out, void* stream) {
  if (n_pairs <= 0) return static_cast<int>(cudaSuccess);
  if (d <= 0 || d % 4 != 0 || n_codes <= 0 || n_codes > kMaxCodes)
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
  g.log_counts = static_cast<const double*>(log_counts);
  g.log_groups = static_cast<const double*>(log_groups);
  g.markov_self = static_cast<const double*>(markov_self);
  g.rank_dev = static_cast<const double*>(rank_dev);
  g.rank_ss = static_cast<const double*>(rank_ss);
  g.h = static_cast<const double*>(h);
  g.n2[0] = static_cast<const double*>(n2r);
  g.n2[1] = static_cast<const double*>(n2rc);
  g.n2[2] = static_cast<const double*>(n2rrc);
  g.n_codes = n_codes;
  g.out = static_cast<double*>(out);
  for (int j = 0; j < n_codes; ++j) {
    const int c = codes[j];
    if (c < kMarkov || c > kN2rrc || (g.mask & bit(c))) return static_cast<int>(cudaErrorInvalidValue);
    g.codes[j] = c;
    g.mask |= bit(c);
  }
  // every plane a selected single reads
  const unsigned m = g.mask;
  if (((m & (bit(kMarkov) | bit(kSimMm))) && (!log_counts || !log_groups)) ||
      ((m & bit(kSimMm)) && !markov_self) || ((m & bit(kSpearman)) && (!rank_dev || !rank_ss)) ||
      ((m & (bit(kD2s) | bit(kD2Star))) && !h) || ((m & bit(kAfd)) && d != 16) ||
      ((m & bit(kN2r)) && !n2r) || ((m & bit(kN2rc)) && !n2rc) || ((m & bit(kN2rrc)) && !n2rrc))
    return static_cast<int>(cudaErrorInvalidValue);
  // one warp a pair; at most 16 blocks an SM, the rest by the stride loop
  const long long want = (n_pairs + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const long long blocks = want < 16LL * sm_count() ? want : 16LL * sm_count();
  plane_singles_kernel<T><<<dim3(static_cast<unsigned>(blocks)), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out [2, n_codes, P] float64: the values, then their bounds, of the plane
// singles with `codes` (model/classifier.py:SINGLE_CODES; a host array),
// for pairs (a_idx[p], b_idx[p]) or (a_idx[p], b_idx[0]) when center = 1.
// Planes that no selected single reads may be null.
int mc2_plane_singles_u8(const void* counts, long long n_rows, int d, int k, const void* a_idx,
                         const void* b_idx, int center, long long n_pairs, const void* mags,
                         const void* real_mags, const void* one_mers, const void* log_counts,
                         const void* log_groups, const void* markov_self, const void* rank_dev,
                         const void* rank_ss, const void* h, const void* n2r, const void* n2rc,
                         const void* n2rrc, const int* codes, int n_codes, void* out,
                         void* stream) {
  return launch<uint8_t>(counts, n_rows, d, k, a_idx, b_idx, center, n_pairs, mags, real_mags,
                         one_mers, log_counts, log_groups, markov_self, rank_dev, rank_ss, h,
                         n2r, n2rc, n2rrc, codes, n_codes, out, stream);
}

int mc2_plane_singles_u16(const void* counts, long long n_rows, int d, int k, const void* a_idx,
                          const void* b_idx, int center, long long n_pairs, const void* mags,
                          const void* real_mags, const void* one_mers, const void* log_counts,
                          const void* log_groups, const void* markov_self, const void* rank_dev,
                          const void* rank_ss, const void* h, const void* n2r, const void* n2rc,
                          const void* n2rrc, const int* codes, int n_codes, void* out,
                          void* stream) {
  return launch<uint16_t>(counts, n_rows, d, k, a_idx, b_idx, center, n_pairs, mags, real_mags,
                          one_mers, log_counts, log_groups, markov_self, rank_dev, rank_ss, h,
                          n2r, n2rc, n2rrc, codes, n_codes, out, stream);
}

}  // extern "C"
