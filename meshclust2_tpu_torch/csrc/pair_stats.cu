// Pair statistics over a device-resident k-mer histogram store, with the
// classifier's float64 epilogue fused in.
//
// For each pair p, with h = counts[a_idx[p]] and c = counts[b_idx[p]]
// (c = counts[b_idx[0]] for every p in the center form):
//   stats[p][0] = sum_i min(h_i, c_i)
//   stats[p][1] = sum_i h_i * c_i
//   stats[p][2] = sum_j |sum_{i<=j} (h_i - c_i)|        (EMD)
// as exact int64, and, in the fused entry, from those three integers and the
// per-row float64 moments of both rows (mags, self dots, stddevs, lens):
//   the model's raw singles (ops/pair_stats.py:derive_singles), their min/max
//   normalization, the combos and the GLM sum s, then
//   prob = 1 / (1 + exp(-clamp(s, +-709))) + bias and dist = combo 0
//   (model/classifier.py:decision_from_raw), written as dec[0][p] = s,
//   dec[1][p] = prob, dec[2][p] = dist, dec[3][p] = s_err and dec[4][p] =
//   dist_err (0 in this instantiation).
//
// The FULL kernel (full_kernel) serves a model with full-vector singles
// (the log divergences jefferey, jensen-shannon, k_div, kl_cond and the
// blockwise hellinger, squared chord, chi^2, canberra, kulczynski1,
// harmonic mean, mismatch, jaccard: ops/pair_stats.py:vector_singles_ref).
// A team of warps takes a pair; each thread sums, from the groups of 4
// consecutive counts (kl_cond's groups; D = 4^k) it loads for the
// statistics, the float64 terms of the model's full-vector singles with
// their companion |term| sums, selected by a mask the block reads from the
// packed parameters; the team's first warp runs the pair's epilogue over
// its lanes, which derives each such single with an absolute error bound
// and propagates the bounds through the normalization, the combos and the
// GLM sum into s_err and dist_err (model/classifier.py:decision_errors).  A
// log's argument is a ratio of exact integer products, (h_i mB) / (c_i mA)
// in place of (h_i / mA) / (c_i / mB), so it rounds once.  Its sums run in
// another order than the plain version's, so its values agree with it
// within the bounds, not bit for bit; its statistics are the same integers.
//
// The PLANE instantiation serves a model with plane singles (markov, sim_mm,
// rre_k_r, spearman, d2s, d2_star, afd, n2r, n2rc, n2rrc: csrc/
// plane_singles.cu, launched just before on the same stream): its epilogue
// reads each such single's value and absolute bound from that kernel's
// [2, S_p, P] buffer, by the single's rank among the model's plane singles,
// and propagates the bounds into s_err and dist_err as FULL does.  Its
// statistics and rounds are the fast instantiation's, each lane's epilogue
// with the bounds; a model with full-vector singles too takes the FULL
// kernel with the plane singles read in its epilogue.
//
// Replaces meshclust2_tpu/ops/pallas_stats.py:_build.kernel, the TPU kernel
// that streams a [tile_b, D] block of candidate rows against ONE center row
// and forms the EMD prefix with 128x128 triangular MXU matmuls and a carry,
// together with the epilogue XLA fuses behind it on the TPU
// (meshclust2_tpu/cluster/device_loop.py:derive_singles_dd, epilogue_dd;
// meshclust2_tpu/cluster/device_update.py:DeviceUpdater._score_core).
//
// What bounds it on an H100.  In the pair form (the update batches, ~10^5
// pairs) the bytes of the two rows a pair, from L2 (a 10,000-row store is
// 10 MB); in the center form (one accumulate window, ~1,600 pairs against one
// center) the latency of one launch and of one warp's chain.  The design:
//   - one warp computes a pair's statistics; lane l owns a contiguous slice
//     of both rows.  Where the slice is whole 16-byte vectors of at most 32
//     counts (D = 1,024 uint8: two vectors; uint16: up to four), it is loaded
//     once and held in registers: sum-min, dot and the slice's diff total
//     come from registers (uint8 with 32-bit sums: four counts a word by
//     __vminu4 and __dp4a), a __shfl_up_sync scan gives the prefix before
//     the slice, and the EMD pass reads the registers again.  Wider slices
//     (D = 4,096, which spill at 64 counts a lane) and unaligned stores keep
//     the two-pass loop, whose second pass re-reads the slice from L1;
//   - 32-bit lane sums when the wrapper proves them exact from the store's
//     largest count (D maxc^2 < 2^31 bounds sum-min, dot and every prefix;
//     ceil(D/32) D maxc < 2^32 bounds a lane's EMD part); the EMD is widened
//     to 64 bits for the warp reduction only.  Otherwise every sum is 64-bit;
//   - the center form stages the center row once a block in shared memory
//     with 16-byte loads;
//   - a warp takes G consecutive pairs, G chosen so that the grid is one
//     wave of the warps the card holds at once (G = 1 for an accumulate
//     window, so every pair has its own warp; ~47 for an update batch of
//     ~10^5 pairs).  In the one-pass path the next pair's rows are loaded
//     while this pair's are summed, and the warp's first pair's rows while
//     the block stages the center.  The xor reductions leave each pair's
//     statistics on every lane; lane j keeps the round's pair j, and after
//     each round of 32 pairs the lanes run their pairs' epilogues side by
//     side, the moments loaded before the round's statistics.  A round of
//     one pair (the center form's one pair a warp) spreads its epilogue over
//     the warp instead: a lane a single, a lane a combo, the GLM sum in
//     combo order from shuffles;
//   - the model's parameters (one packed float64 buffer,
//     model/classifier.py:packed_params) are copied into shared memory once
//     a block, or read from global memory when they do not fit.
//
// Exactness.  The statistics are exact integers for any D and either width.
// The epilogue repeats the plain PyTorch sequence (ops/pair_stats.py:
// derive_singles, model/classifier.py:decision_from_raw) operation for
// operation with explicitly rounded intrinsics, so that nvcc contracts
// nothing into an FMA: a float64 result here equals the plain version's on
// the card bit for bit.  Where PyTorch's CUDA kernels round otherwise than
// the Python reads, this follows PyTorch: mags / d is mags * (1 / d) (a
// division by a host scalar), x**2 is x * x, 1 / x is a correctly rounded
// division, and exp is the CUDA math library's, which PyTorch calls too.
//
// The FULL kernel replaces the XLA programs meshclust2_tpu/cluster/
// device_loop.py:log_div_stats (l. 167) and block_singles_stats (l. 217),
// which the JAX package runs in float32 with error bounds behind the Pallas
// kernel.  What bounds it: operations.  Per pair and element up to four
// float64 logs, three square roots and ten divisions, a few hundred
// float64 instructions, at the card's float64 rate.  So the design keeps
// the float64 pipe fed: S warps a pair where the pairs are few (the center
// form's ~1,600), so that their warps fill the card; each group's counts
// loaded once for the statistics and the log divergences, the blockwise
// terms and the EMD in a second pass over the same slice from L1; the two
// families' sums live one after the other, an element at a time; launch
// bounds of its own (three blocks an SM, 80 registers).
//
// An index outside [0, n_rows) writes -1 into the three statistics of its
// pair and NaN into its s, prob, dist and bounds; callers validate indices
// before launch.
//
// Built by nvcc for sm_90a (ops/_build.py) and bound through ctypes: each
// entry point launches on the given stream, allocates nothing, does not
// synchronise and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarpSize = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpSize * kWarpsPerBlock;
constexpr unsigned kFullMask = 0xffffffffu;
// the singles the kernels compute (model/classifier.py:SINGLE_CODES): the
// statistics-derived ones, then the full-vector ones from kJefferey on, then
// the plane singles from kMarkov on (computed by csrc/plane_singles.cu).  A
// model's singles are distinct, so one without plane singles has at most
// kMaxSingles, which the one-lane epilogue holds; the PLANE epilogue takes
// at most a warp's lanes (the wrapper checks)
constexpr int kMaxSingles = 23;
static_assert(kMaxSingles <= kWarpSize, "the warp epilogue gives a single a lane");
enum Single {
  kManhattan = 0, kEuclidean, kIntersection, kKulczynski2, kSimratio,
  kNormalizedVectors, kPearson, kD2z, kEuclideanZ, kEmd, kLengthd,
  kJefferey, kJensenShannon, kKDiv, kKlCond, kHellinger, kSqchord, kChi2,
  kCanberra, kKulczynski1, kHarmonic, kMismatch, kJaccard,
  kMarkov, kSimMm, kRreKR, kSpearman, kD2s, kD2Star, kAfd, kN2r, kN2rc, kN2rrc,
};
// a full-vector single's bit in the FULL pass's mask
__host__ __device__ constexpr unsigned bit(int code) {
  return 1u << (code - kJefferey);
}
enum Combo { kXY = 0, kXY2 = 1, kX2Y = 2, kX2Y2 = 3 };
constexpr double kU = 1.0 / 9007199254740992.0;   // 2^-53
// packed parameters: [S, C, bias, w0], then 4 a single (code, min,
// max - min, is_sim), then 4 a combo (kind, i0, i1 or -1, weight)
constexpr int kHead = 4;
constexpr int kStride = 4;

struct Args {
  const void* counts;
  long long n_rows;
  int d;
  const long long* a_idx;
  const long long* b_idx;
  long long n_pairs;
  int center;          // 1: b_idx holds one index, the center of every pair
  int center_shared;   // 1: stage the center row in shared memory
  int group;           // G, pairs a warp
  // the fused epilogue; dec == nullptr for the statistics alone
  const double* mags;
  const double* selfdot;
  const double* stddevs;
  const double* lens;
  const double* prm;
  int n_prm;
  int prm_shared;      // 1: copy prm into shared memory
  double inv_d;        // 1 / d, as PyTorch divides by a host scalar
  const double* plane; // PLANE: [2, n_plane, P], plane singles' values, bounds
  int n_plane;
  long long* stats;    // [P, 3]
  double* dec;         // [5, P]: s, prob, dist, s_err, dist_err
};

template <typename T>
union Vec16 {
  uint4 raw;
  T e[16 / sizeof(T)];
};

template <bool NARROW>
struct Acc {
  using U = typename std::conditional<NARROW, unsigned, unsigned long long>::type;
  using S = typename std::conditional<NARROW, int, long long>::type;
};

// warp sum of v, on every lane
template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
#pragma unroll
  for (int delta = kWarpSize / 2; delta > 0; delta >>= 1)
    v += __shfl_xor_sync(kFullMask, v, delta);
  return v;
}

// exclusive warp prefix of v (lane order)
template <typename V>
__device__ __forceinline__ V warp_exclusive(V v, int lane) {
  V incl = v;
#pragma unroll
  for (int delta = 1; delta < kWarpSize; delta <<= 1) {
    const V up = __shfl_up_sync(kFullMask, incl, delta);
    if (lane >= delta) incl += up;
  }
  return incl - v;
}

// the warp's totals (sum-min, dot, EMD) from the lanes' parts
template <bool NARROW>
__device__ __forceinline__ void finish(typename Acc<NARROW>::U smin,
                                       typename Acc<NARROW>::U dot,
                                       typename Acc<NARROW>::U emd,
                                       long long* out) {
  // in the narrow path sum-min and dot totals are < 2^31 too; only the EMD
  // total can pass 2^32
  out[0] = static_cast<long long>(warp_sum(smin));
  out[1] = static_cast<long long>(warp_sum(dot));
  out[2] = static_cast<long long>(warp_sum(static_cast<unsigned long long>(emd)));
}

// Lane l's slice of a row for the one-pass path: NV 16-byte vectors at
// vector l * NV.
template <typename T, int NV>
__device__ __forceinline__ void load_slice(Vec16<T>* v, const T* row, int lane) {
  const uint4* p = reinterpret_cast<const uint4*>(row) + lane * NV;
#pragma unroll
  for (int k = 0; k < NV; ++k) v[k].raw = p[k];
}

// One pass over slices held in registers: sum-min, dot and the diff total,
// the warp scan, then the EMD part from the same registers.
template <typename T, int NV, bool NARROW>
__device__ __forceinline__ void stats_reg(const Vec16<T>* hv, const Vec16<T>* cv,
                                          int lane, long long* out) {
  using U = typename Acc<NARROW>::U;
  using S = typename Acc<NARROW>::S;
  constexpr int E = 16 / sizeof(T);
  U smin = 0, dot = 0;
  S diff = 0;
  if constexpr (sizeof(T) == 1 && NARROW) {
    // four counts a word: byte-wise minimum and dot products into 32 bits
    constexpr unsigned kOnes = 0x01010101u;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const unsigned hw[4] = {hv[k].raw.x, hv[k].raw.y, hv[k].raw.z, hv[k].raw.w};
      const unsigned cw[4] = {cv[k].raw.x, cv[k].raw.y, cv[k].raw.z, cv[k].raw.w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        smin = __dp4a(__vminu4(hw[w], cw[w]), kOnes, smin);
        dot = __dp4a(hw[w], cw[w], dot);
        diff += static_cast<S>(__dp4a(hw[w], kOnes, 0u)) -
                static_cast<S>(__dp4a(cw[w], kOnes, 0u));
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const unsigned x = hv[k].e[e];
        const unsigned y = cv[k].e[e];
        smin += min(x, y);
        dot += static_cast<U>(x * y);
        diff += static_cast<S>(x) - static_cast<S>(y);
      }
    }
  }
  S run = warp_exclusive(diff, lane);
  U emd = 0;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      run += static_cast<S>(hv[k].e[e]) - static_cast<S>(cv[k].e[e]);
      emd += static_cast<U>(run < 0 ? -run : run);
    }
  }
  finish<NARROW>(smin, dot, emd, out);
}

// Two passes over lane l's slice [l * per, (l + 1) * per) clipped to d, as
// 16-byte vectors (VEC) or elements; the second re-reads it from L1.
template <typename T, bool VEC, bool NARROW>
__device__ __forceinline__ void stats_loop(const T* __restrict__ h, const T* c,
                                           int d, int lane, long long* out) {
  using U = typename Acc<NARROW>::U;
  using S = typename Acc<NARROW>::S;
  constexpr int E = 16 / sizeof(T);
  const int per = (d + kWarpSize - 1) / kWarpSize;
  const int start = lane * per;
  const int n = max(0, min(per, d - start));
  h += start;
  c += start;
  U smin = 0, dot = 0;
  S diff = 0;
  if (VEC) {
    for (int off = 0; off < n; off += E) {
      Vec16<T> hv, cv;
      hv.raw = __ldg(reinterpret_cast<const uint4*>(h + off));
      cv.raw = *reinterpret_cast<const uint4*>(c + off);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const unsigned x = hv.e[e];
        const unsigned y = cv.e[e];
        smin += min(x, y);
        dot += static_cast<U>(x * y);
        diff += static_cast<S>(x) - static_cast<S>(y);
      }
    }
  } else {
    for (int i = 0; i < n; ++i) {
      const unsigned x = h[i];
      const unsigned y = c[i];
      smin += min(x, y);
      dot += static_cast<U>(x * y);
      diff += static_cast<S>(x) - static_cast<S>(y);
    }
  }
  S run = warp_exclusive(diff, lane);
  U emd = 0;
  if (VEC) {
    for (int off = 0; off < n; off += E) {
      Vec16<T> hv, cv;
      hv.raw = __ldg(reinterpret_cast<const uint4*>(h + off));
      cv.raw = *reinterpret_cast<const uint4*>(c + off);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        run += static_cast<S>(hv.e[e]) - static_cast<S>(cv.e[e]);
        emd += static_cast<U>(run < 0 ? -run : run);
      }
    }
  } else {
    for (int i = 0; i < n; ++i) {
      run += static_cast<S>(h[i]) - static_cast<S>(c[i]);
      emd += static_cast<U>(run < 0 ? -run : run);
    }
  }
  finish<NARROW>(smin, dot, emd, out);
}

// The float64 moments of a pair's two rows.
struct Moments {
  double ma, mb, sa, sb, ta, tb, la, lb;   // mags, self dots, stddevs, lens
};

// What every single reads: the statistics as float64, ap, aq and the norm.
struct Derived {
  double summin, dot, emd, ap, aq, norm2;
};

__device__ __forceinline__ Derived derive(const long long* st, const Moments& m,
                                          double inv_d) {
  Derived v;
  v.summin = __ll2double_rn(st[0]);
  v.dot = __ll2double_rn(st[1]);
  v.emd = __ll2double_rn(st[2]);
  v.ap = __dmul_rn(m.ma, inv_d);
  v.aq = __dmul_rn(m.mb, inv_d);
  v.norm2 = __dsub_rn(__dadd_rn(m.sa, m.sb), __dmul_rn(2.0, v.dot));
  return v;
}

// One raw single, in ops/pair_stats.py:derive_singles' operation order.
__device__ __forceinline__ double single_raw(int code, const Derived& v,
                                             const Moments& m, double d) {
  const double dot = v.dot, ap = v.ap, aq = v.aq;
  switch (code) {
    case kManhattan:
      return __dsub_rn(__dadd_rn(m.ma, m.mb), __dmul_rn(2.0, v.summin));
    case kEuclidean:
      return __dsqrt_rn(v.norm2);
    case kIntersection:
      return __ddiv_rn(__dmul_rn(2.0, v.summin), __dadd_rn(m.ma, m.mb));
    case kKulczynski2:
      return __dmul_rn(__ddiv_rn(__dmul_rn(d, __dadd_rn(ap, aq)),
                                 __dmul_rn(__dmul_rn(2.0, ap), aq)),
                       v.summin);
    case kSimratio:
      return __ddiv_rn(dot, __dadd_rn(dot, __dsqrt_rn(v.norm2)));
    case kNormalizedVectors:
      return __ddiv_rn(dot, __dsqrt_rn(__dmul_rn(m.sa, m.sb)));
    case kPearson: {
      const double cov = __dsub_rn(dot, __dmul_rn(__dmul_rn(d, ap), aq));
      const double va = __dsub_rn(m.sa, __dmul_rn(d, __dmul_rn(ap, ap)));
      const double vb = __dsub_rn(m.sb, __dmul_rn(d, __dmul_rn(aq, aq)));
      return __ddiv_rn(cov, __dsqrt_rn(__dmul_rn(va, vb)));
    }
    case kD2z:
      return __ddiv_rn(__dsub_rn(dot, __dmul_rn(__dmul_rn(d, ap), aq)),
                       __dmul_rn(m.ta, m.tb));
    case kEuclideanZ: {
      const double na = __ddiv_rn(__dsub_rn(m.sa, __dmul_rn(d, __dmul_rn(ap, ap))),
                                  __dmul_rn(m.ta, m.ta));
      const double nb = __ddiv_rn(__dsub_rn(m.sb, __dmul_rn(d, __dmul_rn(aq, aq))),
                                  __dmul_rn(m.tb, m.tb));
      const double dz = __ddiv_rn(__dsub_rn(dot, __dmul_rn(__dmul_rn(d, ap), aq)),
                                  __dmul_rn(m.ta, m.tb));
      return __dsqrt_rn(__dsub_rn(__dadd_rn(na, nb), __dmul_rn(2.0, dz)));
    }
    case kEmd:
      return v.emd;
    case kLengthd:
      return fabs(__dsub_rn(m.la, m.lb));
  }
  return __longlong_as_double(0x7ff8000000000000LL);   // unreachable: checked
}

// The FULL pass's per-lane, then per-warp, sums over a pair's two rows.
struct FullSums {
  double jd, jd_abs, jd_comp;     // jefferey: terms, |terms|, companion
  double ta, ta_abs, tb, tb_abs;  // jensen-shannon's two sides, k_div the first
  double kp, kp_abs, kq, kq_abs;  // kl_cond's two sides
  double hs, hc;                  // hellinger: squared differences, companion
  double sq, chi, can, kul, har;  // sums of nonnegative terms
  double mis, jac;                // counts
};

// The full-vector singles in two families, each summed in a pass of its
// own so that only its sums are live: the log divergences (jefferey,
// jensen-shannon, k_div, kl_cond) and the blockwise singles.
constexpr unsigned kLogBits = bit(kJefferey) | bit(kJensenShannon) | bit(kKDiv) | bit(kKlCond);
constexpr unsigned kBlockBits = bit(kHellinger) | bit(kSqchord) | bit(kChi2) | bit(kCanberra) |
                                bit(kKulczynski1) | bit(kHarmonic) | bit(kMismatch) |
                                bit(kJaccard);

// The log divergences' terms of one group of 4 consecutive counts x (row
// a) and y (row b), ma and mb the rows' count sums: ops/pair_stats.py:
// _vector_terms, term for term in the same operations.  The companion
// sums feed only the bounds and may round freely.  An element at a time
// (unroll 1): the logs' temporaries of four elements at once would cost
// the registers that let three blocks share an SM (kFullMinBlocks).
__device__ __forceinline__ void full_group_log(unsigned mask, const unsigned* x,
                                               const unsigned* y, double ma, double mb,
                                               FullSums& f) {
#pragma unroll 1
  for (int j = 0; j < 4; ++j) {
    const double a = x[j], b = y[j];
    if (mask & (bit(kJefferey) | bit(kJensenShannon) | bit(kKDiv))) {
      // exact integer products (< 2^40): p_j / q_j = (a mb) / (b ma)
      const double ppn = __dmul_rn(a, mb), pqn = __dmul_rn(b, ma);
      if (mask & bit(kJefferey)) {
        const double dnum = __dsub_rn(ppn, pqn);
        const double lr = log(__ddiv_rn(ppn, pqn));
        const double t = __dmul_rn(dnum, lr);
        f.jd = __dadd_rn(f.jd, t);
        f.jd_abs += fabs(t);
        f.jd_comp += fabs(dnum) + (ppn + pqn) * fabs(lr);
      }
      if (mask & (bit(kJensenShannon) | bit(kKDiv))) {
        const double sn = __dadd_rn(ppn, pqn);
        const double ta = __dmul_rn(a, log(__ddiv_rn(__dmul_rn(2.0, ppn), sn)));
        f.ta = __dadd_rn(f.ta, ta);
        f.ta_abs += fabs(ta);
        if (mask & bit(kJensenShannon)) {
          const double tb = __dmul_rn(b, log(__ddiv_rn(__dmul_rn(2.0, pqn), sn)));
          f.tb = __dadd_rn(f.tb, tb);
          f.tb_abs += fabs(tb);
        }
      }
    }
  }
  if (mask & bit(kKlCond)) {
    // log(cp_j / cq_j) = log((x_j sq) / (y_j sp)): exact integer products
    const double sp = static_cast<double>(x[0] + x[1] + x[2] + x[3]);
    const double sq = static_cast<double>(y[0] + y[1] + y[2] + y[3]);
#pragma unroll 1
    for (int j = 0; j < 4; ++j) {
      const double a = x[j], b = y[j];
      const double lg = log(__ddiv_rn(__dmul_rn(a, sq), __dmul_rn(b, sp)));
      const double tp = __dmul_rn(a, lg), tq = __dmul_rn(b, lg);
      f.kp = __dadd_rn(f.kp, tp);
      f.kp_abs += fabs(tp);
      f.kq = __dadd_rn(f.kq, tq);
      f.kq_abs += fabs(tq);
    }
  }
}

// The blockwise singles' terms of one group, as full_group_log.
__device__ __forceinline__ void full_group_block(unsigned mask, const unsigned* x,
                                                 const unsigned* y, double ma, double mb,
                                                 double d, FullSums& f) {
#pragma unroll 1
  for (int j = 0; j < 4; ++j) {
    const double a = x[j], b = y[j];
    if (mask & bit(kHellinger)) {
      const double xa = __dsqrt_rn(__ddiv_rn(__dmul_rn(a, d), ma));
      const double xb = __dsqrt_rn(__ddiv_rn(__dmul_rn(b, d), mb));
      const double df = __dsub_rn(xa, xb);
      f.hs = __dadd_rn(f.hs, __dmul_rn(df, df));
      f.hc += fabs(df) * (xa + xb);
    }
    if (mask & bit(kSqchord)) {
      f.sq = __dadd_rn(f.sq, __dsub_rn(__dadd_rn(a, b),
                                       __dmul_rn(2.0, __dsqrt_rn(__dmul_rn(a, b)))));
    }
    const double df = __dsub_rn(a, b);   // exact
    if (mask & bit(kChi2))
      f.chi = __dadd_rn(f.chi, __ddiv_rn(__dmul_rn(df, df), __dadd_rn(a, b)));
    if (mask & bit(kCanberra)) f.can = __dadd_rn(f.can, __ddiv_rn(fabs(df), __dadd_rn(a, b)));
    if (mask & bit(kKulczynski1)) f.kul = __dadd_rn(f.kul, __ddiv_rn(fabs(df), fmin(a, b)));
    if (mask & bit(kHarmonic))
      f.har = __dadd_rn(f.har, __ddiv_rn(__dmul_rn(a, b), __dadd_rn(a, b)));
    if (mask & bit(kMismatch)) f.mis += x[j] != y[j] ? 1.0 : 0.0;
    if (mask & bit(kJaccard)) f.jac += x[j] == y[j] && x[j] > 1 ? 1.0 : 0.0;
  }
}


// A full-vector single from the warp's sums, and into *err its absolute
// bound on |value - the host's|: ops/pair_stats.py:_vector_terms.  hs =
// (D + 64) u covers either side's sum of D terms, e16 = 16 u the roundings
// of a term on both sides (u = 2^-53); the count sums ma, mb make the
// constant parts.
__device__ __forceinline__ double full_single(int code, const FullSums& f, double ma,
                                              double mb, double d, double inv_d,
                                              double* err) {
  constexpr double u = 1.0 / 9007199254740992.0;   // 2^-53
  const double hs = (d + 64.0) * u, e16 = 16.0 * u;
  switch (code) {
    case kJefferey: {
      const double mm = __dmul_rn(ma, mb);
      *err = (hs * f.jd_abs + e16 * f.jd_comp) / mm;
      return __ddiv_rn(f.jd, mm);
    }
    case kJensenShannon: {
      const double t = 0.5 * (f.ta_abs / ma + f.tb_abs / mb);
      *err = hs * t + e16 * (t + 1.0);
      return __dmul_rn(0.5, __dadd_rn(__ddiv_rn(f.ta, ma), __ddiv_rn(f.tb, mb)));
    }
    case kKDiv: {
      const double t = f.ta_abs / ma;
      *err = hs * t + e16 * (t + 1.0);
      return __ddiv_rn(f.ta, ma);
    }
    case kKlCond: {
      const double t = 0.5 * (f.kp_abs / ma + f.kq_abs / mb);
      *err = hs * t + e16 * (t + 1.0);
      return __dmul_rn(0.5, __dsub_rn(__ddiv_rn(f.kp, ma), __ddiv_rn(f.kq, mb)));
    }
    case kHellinger: {
      const double v = __dsqrt_rn(__dmul_rn(2.0, f.hs));
      const double es = hs * f.hs + e16 * f.hc;
      // |sqrt(2 s1) - sqrt(2 s2)| <= 2 e / max(v, sqrt(2 e)) for |s1 - s2| <= e
      *err = (es > 0.0 ? 2.0 * es / fmax(v, sqrt(2.0 * es)) : 0.0) + 4.0 * u * v;
      return v;
    }
    case kSqchord:
      *err = hs * f.sq + e16 * (ma + mb);
      return f.sq;
    case kChi2:
      *err = (hs + e16) * f.chi;
      return f.chi;
    case kCanberra:
      *err = (hs + e16) * f.can;
      return f.can;
    case kKulczynski1:
      *err = (hs + e16) * f.kul;
      return f.kul;
    case kHarmonic: {
      const double v = __dmul_rn(2.0, f.har);
      *err = (hs + e16) * v;
      return v;
    }
    case kMismatch:
      *err = 0.0;
      return f.mis;
    case kJaccard:
      *err = 0.0;
      return __dmul_rn(f.jac, inv_d);   // 1 / d is a power of two: exact
  }
  *err = 0.0;
  return __longlong_as_double(0x7ff8000000000000LL);   // unreachable: checked
}

// The product c z and its first-order absolute error bound from ce and ze
// (model/classifier.py:_mul_err).
__device__ __forceinline__ void mul_err(double& c, double& ce, double z, double ze) {
  ce = __dadd_rn(__dmul_rn(ce, fabs(z)), __dmul_rn(ze, fabs(c)));
  c = __dmul_rn(c, z);
}

// A combo's error bound from its singles' normalized values x, y and
// bounds xe, ye (model/classifier.py:_combo_err).
__device__ __forceinline__ double combo_err(int kind, double x, double xe, double y,
                                            double ye, bool has_y) {
  double c = x, ce = xe;
  if (kind == kXY) {
    if (has_y) mul_err(c, ce, y, ye);
  } else if (kind == kX2Y2) {
    mul_err(c, ce, x, xe);
    if (has_y) {
      mul_err(c, ce, y, ye);
      mul_err(c, ce, y, ye);
    }
  } else if (kind == kXY2) {
    mul_err(c, ce, y, ye);
    mul_err(c, ce, y, ye);
  } else {
    mul_err(c, ce, x, xe);
    mul_err(c, ce, y, ye);
  }
  return ce;
}

// Single k of the model, normalized: (raw - min) / (max - min), and
// 1 - that for a distance (model/classifier.py:decision_from_raw).
__device__ __forceinline__ double single_normalized(const double* prm, int k,
                                                    const Derived& v,
                                                    const Moments& m, double d) {
  const double* q = prm + kHead + kStride * k;
  const double raw = single_raw(static_cast<int>(q[0]), v, m, d);
  const double x = __ddiv_rn(__dsub_rn(raw, q[1]), q[2]);
  return q[3] != 0.0 ? x : __dsub_rn(1.0, x);
}

// A combo's value from its singles' normalized values (has_y false: a
// combo of one single, whose product runs over x alone).
__device__ __forceinline__ double combo_value(int kind, double x, double y, bool has_y) {
  if (kind == kXY) return has_y ? __dmul_rn(x, y) : x;
  if (kind == kX2Y2) return has_y ? __dmul_rn(__dmul_rn(x, x), __dmul_rn(y, y)) : __dmul_rn(x, x);
  if (kind == kXY2) return __dmul_rn(__dmul_rn(x, y), y);
  return __dmul_rn(__dmul_rn(x, x), y);
}

// A pair's five outputs, each n_pairs apart from the last.
struct Out {
  double* p;
  long long n;
  __device__ __forceinline__ void write(int row, double v) const { p[row * n] = v; }
};

// s = w0 + the GLM dot (w0 alone without combos), prob, dist and the
// bounds s_err, dist_err.
__device__ __forceinline__ void write_decision(const double* prm, int n_c, double glm,
                                               double dist, double s_err, double dist_err,
                                               const Out& out) {
  const double s = n_c ? __dadd_rn(prm[3], glm) : prm[3];
  // torch.clamp keeps a NaN
  const double sc = isnan(s) ? s : fmin(fmax(s, -709.0), 709.0);
  out.write(0, s);
  out.write(1, __dadd_rn(__ddiv_rn(1.0, __dadd_rn(1.0, exp(-sc))), prm[2]));
  out.write(2, n_c ? dist : 0.0);
  out.write(3, n_c ? s_err : 0.0);
  out.write(4, n_c ? dist_err : 0.0);
}

// One pair's plane singles from csrc/plane_singles.cu: value j at p[j n],
// its bound at p[(s + j) n].
struct PlaneIn {
  const double* p;
  long long n;
  int s;
  __device__ __forceinline__ double value(int j) const { return p[j * n]; }
  __device__ __forceinline__ double bound(int j) const { return p[(s + j) * n]; }
};

// The epilogue of one pair on one lane: (s, prob, dist) in
// model/classifier.py:decision_from_raw's operation order, the GLM dot in
// combo order; a model without full-vector singles, whose bounds are 0.
// PLANE (a model with plane singles): each plane single's value and bound
// from `pl`, by its rank among the model's plane singles, and the bounds
// propagated as epilogue_warp does (model/classifier.py:decision_errors),
// operation for operation, so both give the same bits.
template <bool PLANE>
__device__ __forceinline__ void epilogue(const double* __restrict__ prm,
                                         const long long* st, const Moments& m,
                                         double d, double inv_d, const PlaneIn& pl,
                                         const Out& out) {
  const int n_s = static_cast<int>(prm[0]);
  const int n_c = static_cast<int>(prm[1]);
  const Derived v = derive(st, m, inv_d);
  double nv[kMaxSingles];
  if constexpr (PLANE) {
    double ne[kMaxSingles];
    int jp = 0;
    for (int k = 0; k < n_s; ++k) {
      const double* q = prm + kHead + kStride * k;
      const int code = static_cast<int>(q[0]);
      double raw, err = 0.0;
      if (code >= kMarkov) {
        raw = pl.value(jp);
        err = pl.bound(jp);
        ++jp;
      } else {
        raw = single_raw(code, v, m, d);
      }
      const double x = __ddiv_rn(__dsub_rn(raw, q[1]), q[2]);
      nv[k] = q[3] != 0.0 ? x : __dsub_rn(1.0, x);
      ne[k] = __ddiv_rn(err, fabs(q[2])) + 6.0 * kU * (fabs(nv[k]) + 1.0);
    }
    const double* cq = prm + kHead + kStride * n_s;
    double glm = 0.0, dist = 0.0, s_err = 0.0, dist_err = 0.0, mag = fabs(prm[3]);
    for (int j = 0; j < n_c; ++j, cq += kStride) {
      const int kind = static_cast<int>(cq[0]), i0 = static_cast<int>(cq[1]);
      const int i1 = static_cast<int>(cq[2]);
      const double x = nv[i0], y = i1 >= 0 ? nv[i1] : 1.0;
      const double c = combo_value(kind, x, y, i1 >= 0);
      const double ce =
          combo_err(kind, x, ne[i0], y, i1 >= 0 ? ne[i1] : 0.0, i1 >= 0) + 8.0 * kU * fabs(c);
      const double pe = __dmul_rn(ce, fabs(cq[3]));
      const double prod = __dmul_rn(c, cq[3]);
      mag += fabs(prod);
      if (j == 0) {
        glm = prod;
        dist = c;
        s_err = pe;
        dist_err = ce;
      } else {
        glm = __dadd_rn(glm, prod);
        s_err = __dadd_rn(s_err, pe);
      }
    }
    write_decision(prm, n_c, glm, dist, s_err + 2.0 * (n_c + 2) * kU * mag, dist_err, out);
  } else {
    for (int k = 0; k < n_s; ++k) nv[k] = single_normalized(prm, k, v, m, d);
    const double* cq = prm + kHead + kStride * n_s;
    double glm = 0.0, dist = 0.0;
    for (int j = 0; j < n_c; ++j, cq += kStride) {
      const int i1 = static_cast<int>(cq[2]);
      const double c = combo_value(static_cast<int>(cq[0]), nv[static_cast<int>(cq[1])],
                                   i1 >= 0 ? nv[i1] : 1.0, i1 >= 0);
      if (j == 0) {
        glm = __dmul_rn(c, cq[3]);
        dist = c;
      } else {
        glm = __dadd_rn(glm, __dmul_rn(c, cq[3]));
      }
    }
    write_decision(prm, n_c, glm, dist, 0.0, 0.0, out);
  }
}


// Single k's raw value and absolute bound in the FULL and PLANE epilogues:
// a plane single from `pl`, by its rank among the model's plane singles; a
// full-vector single from the warp's sums; any other from the statistics
// (bound 0).
template <bool FULL, bool PLANE>
__device__ __forceinline__ double raw_with_err(const double* prm, int k, const Derived& v,
                                               const Moments& m, const FullSums& fs,
                                               const PlaneIn& pl, double d, double inv_d,
                                               double* err) {
  const int code = static_cast<int>(prm[kHead + kStride * k]);
  *err = 0.0;
  if constexpr (PLANE) {
    if (code >= kMarkov) {
      int j = 0;
      for (int t = 0; t < k; ++t) j += static_cast<int>(prm[kHead + kStride * t]) >= kMarkov;
      *err = pl.bound(j);
      return pl.value(j);
    }
  }
  if constexpr (FULL) {
    if (code >= kJefferey) return full_single(code, fs, m.ma, m.mb, d, inv_d, err);
  }
  return single_raw(code, v, m, d);
}

// The same epilogue of one pair spread over the warp, for a round of one
// pair (the center form's one pair a warp) and every pair of the FULL
// kernel: lane k normalizes single k, lane j forms combo j and its product
// with its weight, and every lane adds the products in combo order from
// shuffles; lane 0 writes.  Every lane holds the pair's statistics,
// moments and, with FULL, the full-vector sums.  The values and their
// order of operations are the one-lane epilogue's, so the bits are too;
// without FULL or PLANE the bounds are 0.  With FULL, lane k also carries single
// k's bound over |max - min|, lane j combo j's bound (combo_err) and its
// product with |w_j|, added in combo order into s_err; dist_err is combo
// 0's bound (model/classifier.py:decision_errors).  PLANE does the same
// with the plane singles' bounds.
template <bool FULL, bool PLANE>
__device__ __forceinline__ void epilogue_warp(const double* __restrict__ prm,
                                              const long long* st, const Moments& m,
                                              const FullSums& fs, const PlaneIn& pl, double d,
                                              double inv_d, int lane, const Out& out) {
  constexpr bool ERR = FULL || PLANE;
  const int n_s = static_cast<int>(prm[0]);
  const int n_c = static_cast<int>(prm[1]);
  const Derived v = derive(st, m, inv_d);
  double nv = 0.0, ne = 0.0;
  if (lane < n_s) {
    if constexpr (ERR) {
      const double* q = prm + kHead + kStride * lane;
      double err = 0.0;
      const double raw = raw_with_err<FULL, PLANE>(prm, lane, v, m, fs, pl, d, inv_d, &err);
      const double x = __ddiv_rn(__dsub_rn(raw, q[1]), q[2]);
      nv = q[3] != 0.0 ? x : __dsub_rn(1.0, x);
      ne = __ddiv_rn(err, fabs(q[2])) + 6.0 * kU * (fabs(nv) + 1.0);
    } else {
      nv = single_normalized(prm, lane, v, m, d);
    }
  }
  const double* cq0 = prm + kHead + kStride * n_s;
  double glm = 0.0, dist = 0.0, s_err = 0.0, dist_err = 0.0, mag = fabs(prm[3]);
  for (int cb = 0; cb < n_c; cb += kWarpSize) {   // uniform
    const int j = cb + lane;
    int kind = kXY, i0 = 0, i1 = -1;
    double w = 0.0;
    if (j < n_c) {
      const double* cq = cq0 + kStride * j;
      kind = static_cast<int>(cq[0]);
      i0 = static_cast<int>(cq[1]);
      i1 = static_cast<int>(cq[2]);
      w = cq[3];
    }
    const double x = __shfl_sync(kFullMask, nv, i0);
    const double y = __shfl_sync(kFullMask, nv, i1 >= 0 ? i1 : 0);
    const double c = combo_value(kind, x, i1 >= 0 ? y : 1.0, i1 >= 0);
    const double prod = __dmul_rn(c, w);
    double ce = 0.0, pe = 0.0;
    if constexpr (ERR) {
      const double xe = __shfl_sync(kFullMask, ne, i0);
      const double ye = __shfl_sync(kFullMask, ne, i1 >= 0 ? i1 : 0);
      ce = combo_err(kind, x, xe, i1 >= 0 ? y : 1.0, ye, i1 >= 0) + 8.0 * kU * fabs(c);
      pe = __dmul_rn(ce, fabs(w));
    }
    const int n = min(kWarpSize, n_c - cb);
    for (int t = 0; t < n; ++t) {
      const double ct = __shfl_sync(kFullMask, c, t);
      const double pt = __shfl_sync(kFullMask, prod, t);
      if (cb + t == 0) {
        glm = pt;
        dist = ct;
      } else {
        glm = __dadd_rn(glm, pt);
      }
      if constexpr (ERR) {
        const double et = __shfl_sync(kFullMask, pe, t);
        mag += fabs(pt);
        if (cb + t == 0) {
          s_err = et;
          dist_err = __shfl_sync(kFullMask, ce, 0);
        } else {
          s_err = __dadd_rn(s_err, et);
        }
      }
    }
  }
  // the two sides' own roundings of the GLM sum (decision_errors)
  if constexpr (ERR) s_err += 2.0 * (n_c + 2) * kU * mag;
  if (lane == 0) write_decision(prm, n_c, glm, dist, s_err, dist_err, out);
}

// A pair's two rows and whether both indices are in range.
struct Pair {
  long long a, b;
  bool ok;
};

__device__ __forceinline__ Pair pair_at(const Args& args, long long p, bool c_ok) {
  Pair q;
  q.a = args.a_idx[p];
  q.b = args.center ? args.b_idx[0] : args.b_idx[p];
  q.ok = q.a >= 0 && q.a < args.n_rows &&
         (args.center ? c_ok : q.b >= 0 && q.b < args.n_rows);
  return q;
}

// NV > 0: the one-pass register path with NV vectors a lane, the next
// pair's rows loaded while this one's are summed; NV == 0: the two-pass
// loop over 16-byte vectors; NV == -1: the two-pass loop over elements.
// A warp takes `group` consecutive pairs in rounds of 32: lane j keeps the
// statistics of the round's pair j, then lanes 0..31 run the round's
// epilogues, their moments loaded before the round's statistics; a round
// of one pair runs its epilogue over the whole warp (epilogue_warp).  The
// PLANE instantiation reads the plane singles' values and bounds in the
// same epilogues; the FULL one is full_kernel below.
template <typename T, int NV, bool NARROW, bool PLANE>
__global__ void __launch_bounds__(kThreads, 2) pair_stats_kernel(const Args args) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % kWarpSize;
  const int warp = threadIdx.x / kWarpSize;
  const T* counts = static_cast<const T*>(args.counts);
  const int d = args.d;
  const long long n_pairs = args.n_pairs;
  const long long first =
      (static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp) * args.group;
  const long long last = min(first + args.group, n_pairs);   // exclusive

  bool c_ok = true;
  if (args.center) {
    const long long b = args.b_idx[0];
    c_ok = b >= 0 && b < args.n_rows;
  }
  // the warp's first pair's rows, in flight while the block stages the
  // center and the parameters
  constexpr int kNV = NV > 0 ? NV : 1;
  Vec16<T> hn[kNV], cn[kNV];
  Pair next{-1, -1, false};
  if constexpr (NV > 0) {
    if (first < last) {
      next = pair_at(args, first, c_ok);
      if (next.ok) {
        load_slice<T, NV>(hn, counts + next.a * d, lane);
        if (!args.center) load_slice<T, NV>(cn, counts + next.b * d, lane);
      }
    }
  }

  // each lane's pair of the round (in a round of one pair, that pair on
  // every lane): its indices and moments, the first round's before the
  // barrier, so that their loads overlap the statistics
  Pair mine{-1, -1, false};
  Moments mom{};
  auto load_mine = [&](long long base, bool solo) {
    const long long p = base + (solo ? 0 : lane);
    mine = Pair{-1, -1, false};
    if (p < last) {
      mine = pair_at(args, p, c_ok);
      if (mine.ok && args.dec != nullptr) {
        mom = Moments{args.mags[mine.a],    args.mags[mine.b],
                      args.selfdot[mine.a], args.selfdot[mine.b],
                      args.stddevs[mine.a], args.stddevs[mine.b],
                      args.lens[mine.a],    args.lens[mine.b]};
      }
    }
  };
  if (first < last) load_mine(first, last - first == 1);

  const double* prm = args.prm;
  int used = 0;
  if (args.dec != nullptr && args.prm_shared) {
    double* s_prm = reinterpret_cast<double*>(smem);
    for (int i = threadIdx.x; i < args.n_prm; i += kThreads) s_prm[i] = args.prm[i];
    prm = s_prm;
    used = (args.n_prm * 8 + 15) / 16 * 16;
  }
  const T* crow = nullptr;
  if (args.center && c_ok) {
    crow = counts + args.b_idx[0] * d;
    if (args.center_shared) {
      T* s_row = reinterpret_cast<T*>(smem + used);
      const int bytes = d * static_cast<int>(sizeof(T));
      if (bytes % 16 == 0 && reinterpret_cast<uintptr_t>(crow) % 16 == 0) {
        const uint4* src = reinterpret_cast<const uint4*>(crow);
        uint4* dst = reinterpret_cast<uint4*>(s_row);
        for (int i = threadIdx.x; i < bytes / 16; i += kThreads) dst[i] = __ldg(src + i);
      } else {
        for (int i = threadIdx.x; i < d; i += kThreads) s_row[i] = crow[i];
      }
      crow = s_row;
    }
  }
  __syncthreads();
  if (first >= last) return;   // uniform across the warp; no barrier follows
  if constexpr (NV > 0) {
    if (args.center && c_ok) load_slice<T, NV>(cn, crow, lane);
  }

  for (long long base = first; base < last; base += kWarpSize) {
    const int count = static_cast<int>(min(static_cast<long long>(kWarpSize), last - base));
    // a round of one pair: the epilogue spreads over the warp
    const bool solo = count == 1;
    if (base != first) load_mine(base, solo);
    long long kept[3] = {-1, -1, -1};
    for (int j = 0; j < count; ++j) {
      long long st[3] = {-1, -1, -1};
      if constexpr (NV > 0) {
        Vec16<T> hv[NV], cv[NV];
        const Pair cur = next;
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          hv[k] = hn[k];
          cv[k] = cn[k];
        }
        // the next pair's rows go in flight before this one is summed
        if (base + j + 1 < last) {
          next = pair_at(args, base + j + 1, c_ok);
          if (next.ok) {
            load_slice<T, NV>(hn, counts + next.a * d, lane);
            if (!args.center) load_slice<T, NV>(cn, counts + next.b * d, lane);
          }
        }
        if (cur.ok) stats_reg<T, NV, NARROW>(hv, cv, lane, st);   // uniform
      } else {
        const Pair cur = pair_at(args, base + j, c_ok);
        if (cur.ok) {   // uniform
          const T* c = args.center ? crow : counts + cur.b * d;
          stats_loop<T, NV == 0, NARROW>(counts + cur.a * d, c, d, lane, st);
        }
      }
      // the xor reductions left the totals on every lane
      if (lane == j || solo) {
        kept[0] = st[0];
        kept[1] = st[1];
        kept[2] = st[2];
      }
    }
    const long long p = base + (solo ? 0 : lane);
    if (lane < count) {
      long long* so = args.stats + 3 * p;
      so[0] = kept[0];
      so[1] = kept[1];
      so[2] = kept[2];
    }
    if (args.dec == nullptr) continue;   // uniform
    const Out out{args.dec + p, n_pairs};
    const PlaneIn pl = PLANE ? PlaneIn{args.plane + p, n_pairs, args.n_plane} : PlaneIn{};
    if (!mine.ok) {
      if (lane < count) {
        for (int r = 0; r < 5; ++r) out.write(r, __longlong_as_double(0x7ff8000000000000LL));
      }
    } else if (solo) {   // uniform: every lane holds the one pair
      epilogue_warp<false, PLANE>(prm, kept, mom, FullSums{}, pl, static_cast<double>(d),
                                  args.inv_d, lane, out);
    } else if (lane < count) {
      epilogue<PLANE>(prm, kept, mom, static_cast<double>(d), args.inv_d, pl, out);
    }
  }
}

// FULL (a model with full-vector singles; with PLANE also plane singles):
// a team of S warps takes a pair (S = 1 when there are pairs enough to fill
// the card, up to 4 or 8 in the center form), thread t of the team a
// contiguous slice of whole groups of 4 counts.  Pass 1 loads each group
// once into registers and sums from them the statistics' parts (sum-min,
// dot, the slice's diff) and the log divergences' terms; the team's
// exclusive prefix of the diffs (a warp scan, then the earlier warps'
// totals) starts pass 2, which reads the slice again from L1 or the staged
// center row for the EMD and the blockwise terms.  Each warp's butterfly
// totals go to its row of kSlots in shared memory, the team meets behind
// a named barrier after each pass, and lane i of the team's first warp adds
// slot i over the warps in warp order; that warp then runs the pair's
// epilogue (epilogue_warp), the slots gathered by shuffles.  One family's
// sums are live at a time.
enum Slot {
  kSlotDiff = 0, kSlotSmin, kSlotDot,   // int64
  kSlotJd, kSlotJdAbs, kSlotJdComp, kSlotTa, kSlotTaAbs, kSlotTb, kSlotTbAbs,
  kSlotKp, kSlotKpAbs, kSlotKq, kSlotKqAbs,   // the log divergences (pass 1)
  kSlotEmd,                             // int64
  kSlotHs, kSlotHc, kSlotSq, kSlotChi, kSlotCan, kSlotKul, kSlotHar, kSlotMis,
  kSlotJac,                             // the blockwise singles (pass 2)
  kSlots
};
static_assert(kSlots <= kWarpSize, "a lane a slot");
constexpr int kFullMinBlocks = 3;

// The 4 counts of group q; `vec`: one 4- or 8-byte load (rows aligned).
template <typename T>
__device__ __forceinline__ void load4(const T* row, int q, bool vec, unsigned (&x)[4]) {
  if (vec) {
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
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = row[4 * q + j];
  }
}

__device__ __forceinline__ long long as_bits(double v) { return __double_as_longlong(v); }

template <typename T, bool PLANE>
__global__ void __launch_bounds__(kThreads, kFullMinBlocks) full_kernel(const Args args) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / kWarpSize;
  const int lane = threadIdx.x % kWarpSize;
  const int split = args.group;   // S, warps a pair
  const int teams = kWarpsPerBlock / split;
  const int team = warp / split;
  const int tw = warp - team * split;   // the warp's rank in its team
  const int nt = split * kWarpSize;
  const int tt = threadIdx.x - team * nt;
  const T* counts = static_cast<const T*>(args.counts);
  const int d = args.d;
  const long long n_pairs = args.n_pairs;
  bool c_ok = true;
  if (args.center) {
    const long long b = args.b_idx[0];
    c_ok = b >= 0 && b < args.n_rows;
  }
  // the parameters and the center row in shared memory, as
  // pair_stats_kernel stages them, then the warps' slots
  const double* prm = args.prm;
  int used = 0;
  if (args.prm_shared) {
    double* s_prm = reinterpret_cast<double*>(smem);
    for (int i = threadIdx.x; i < args.n_prm; i += kThreads) s_prm[i] = args.prm[i];
    prm = s_prm;
    used = (args.n_prm * 8 + 15) / 16 * 16;
  }
  const T* crow = nullptr;
  if (args.center && c_ok) {
    crow = counts + args.b_idx[0] * d;
    if (args.center_shared) {
      T* s_row = reinterpret_cast<T*>(smem + used);
      const int bytes = d * static_cast<int>(sizeof(T));
      if (bytes % 16 == 0 && reinterpret_cast<uintptr_t>(crow) % 16 == 0) {
        const uint4* src = reinterpret_cast<const uint4*>(crow);
        uint4* dst = reinterpret_cast<uint4*>(s_row);
        for (int i = threadIdx.x; i < bytes / 16; i += kThreads) dst[i] = __ldg(src + i);
      } else {
        for (int i = threadIdx.x; i < d; i += kThreads) s_row[i] = crow[i];
      }
      crow = s_row;
    }
  }
  if (args.center && args.center_shared) used += (d * static_cast<int>(sizeof(T)) + 15) / 16 * 16;
  long long* slots = reinterpret_cast<long long*>(smem + used);
  long long* mine = slots + warp * kSlots;              // this warp's row
  const long long* team_rows = slots + team * split * kSlots;
  __syncthreads();

  // the model's full-vector singles, by their bits
  unsigned mask = 0;
  const int n_s = static_cast<int>(prm[0]);
  for (int k = 0; k < n_s; ++k) {
    const int code = static_cast<int>(prm[kHead + kStride * k]);
    if (code >= kJefferey && code < kMarkov) mask |= bit(code);
  }
  const bool vec = reinterpret_cast<uintptr_t>(counts) % 16 == 0;
  const double dd = static_cast<double>(d);
  const int n_groups = d / 4;
  const int per = (n_groups + nt - 1) / nt;
  const int g0 = min(n_groups, tt * per), g1 = min(n_groups, g0 + per);
  auto sync = [&]() {
    if (split == 1) {
      __syncwarp();
    } else {
      asm volatile("bar.sync %0, %1;" ::"r"(1 + team), "r"(nt) : "memory");
    }
  };
  // lane i of the team's first warp: slot i's total over the warps
  auto total = [&](int i) -> long long {
    if (i == kSlotSmin || i == kSlotDot || i == kSlotEmd) {
      long long v = team_rows[i];
      for (int w = 1; w < split; ++w) v += team_rows[w * kSlots + i];
      return v;
    }
    double v = __longlong_as_double(team_rows[i]);
    for (int w = 1; w < split; ++w) v += __longlong_as_double(team_rows[w * kSlots + i]);
    return as_bits(v);
  };

  for (long long p = static_cast<long long>(blockIdx.x) * teams + team; p < n_pairs;
       p += static_cast<long long>(gridDim.x) * teams) {
    const Pair cur = pair_at(args, p, c_ok);
    const Out out{args.dec + p, n_pairs};
    if (!cur.ok) {   // uniform across the team
      if (tt == 0) {
        long long* so = args.stats + 3 * p;
        so[0] = so[1] = so[2] = -1;
        for (int r = 0; r < 5; ++r) out.write(r, __longlong_as_double(0x7ff8000000000000LL));
      }
      continue;
    }
    const T* h = counts + cur.a * d;
    const T* c = args.center ? crow : counts + cur.b * d;
    const double ma = args.mags[cur.a], mb = args.mags[cur.b];

    // pass 1: the statistics' parts and the log divergences
    long long smin = 0, dot = 0, diff = 0;
    {
      FullSums f{};
      for (int q = g0; q < g1; ++q) {
        unsigned x[4], y[4];
        load4(h, q, vec, x);
        load4(c, q, vec, y);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          smin += min(x[j], y[j]);
          dot += static_cast<long long>(x[j]) * y[j];
          diff += static_cast<long long>(x[j]) - static_cast<long long>(y[j]);
        }
        if (mask & kLogBits) full_group_log(mask, x, y, ma, mb, f);
      }
      const long long wd = warp_sum(diff), ws = warp_sum(smin), wo = warp_sum(dot);
      if (lane == 0) {
        mine[kSlotDiff] = wd;
        mine[kSlotSmin] = ws;
        mine[kSlotDot] = wo;
      }
      if (mask & kLogBits) {
        const double v[11] = {f.jd, f.jd_abs, f.jd_comp, f.ta, f.ta_abs, f.tb,
                              f.tb_abs, f.kp, f.kp_abs, f.kq, f.kq_abs};
#pragma unroll
        for (int i = 0; i < 11; ++i) {
          const double w = warp_sum(v[i]);
          if (lane == 0) mine[kSlotJd + i] = as_bits(w);
        }
      }
    }
    sync();
    long long run = warp_exclusive(diff, lane);
    for (int w = 0; w < tw; ++w) run += team_rows[w * kSlots + kSlotDiff];
    long long held = 0;   // the first warp: lane i's slot total
    if (tw == 0 && lane >= kSlotSmin && lane < kSlotEmd &&
        (lane <= kSlotDot || (mask & kLogBits)))
      held = total(lane);

    // pass 2: the EMD and the blockwise singles
    {
      unsigned long long emd = 0;
      FullSums f{};
      for (int q = g0; q < g1; ++q) {
        unsigned x[4], y[4];
        load4(h, q, vec, x);
        load4(c, q, vec, y);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          run += static_cast<long long>(x[j]) - static_cast<long long>(y[j]);
          emd += static_cast<unsigned long long>(run < 0 ? -run : run);
        }
        if (mask & kBlockBits) full_group_block(mask, x, y, ma, mb, dd, f);
      }
      const unsigned long long we = warp_sum(emd);
      if (lane == 0) mine[kSlotEmd] = static_cast<long long>(we);
      if (mask & kBlockBits) {
        const double v[9] = {f.hs, f.hc, f.sq, f.chi, f.can, f.kul, f.har, f.mis, f.jac};
#pragma unroll
        for (int i = 0; i < 9; ++i) {
          const double w = warp_sum(v[i]);
          if (lane == 0) mine[kSlotHs + i] = as_bits(w);
        }
      }
    }
    sync();
    if (tw != 0) continue;   // the team's first warp finishes the pair
    if (lane >= kSlotEmd && lane < kSlots && (lane == kSlotEmd || (mask & kBlockBits)))
      held = total(lane);
    long long st[3];
    st[0] = __shfl_sync(kFullMask, held, kSlotSmin);
    st[1] = __shfl_sync(kFullMask, held, kSlotDot);
    st[2] = __shfl_sync(kFullMask, held, kSlotEmd);
    auto slot = [&](int i) { return __longlong_as_double(__shfl_sync(kFullMask, held, i)); };
    FullSums fs;
    fs.jd = slot(kSlotJd);
    fs.jd_abs = slot(kSlotJdAbs);
    fs.jd_comp = slot(kSlotJdComp);
    fs.ta = slot(kSlotTa);
    fs.ta_abs = slot(kSlotTaAbs);
    fs.tb = slot(kSlotTb);
    fs.tb_abs = slot(kSlotTbAbs);
    fs.kp = slot(kSlotKp);
    fs.kp_abs = slot(kSlotKpAbs);
    fs.kq = slot(kSlotKq);
    fs.kq_abs = slot(kSlotKqAbs);
    fs.hs = slot(kSlotHs);
    fs.hc = slot(kSlotHc);
    fs.sq = slot(kSlotSq);
    fs.chi = slot(kSlotChi);
    fs.can = slot(kSlotCan);
    fs.kul = slot(kSlotKul);
    fs.har = slot(kSlotHar);
    fs.mis = slot(kSlotMis);
    fs.jac = slot(kSlotJac);
    if (lane == 0) {
      long long* so = args.stats + 3 * p;
      so[0] = st[0];
      so[1] = st[1];
      so[2] = st[2];
    }
    const Moments mom{args.mags[cur.a],    args.mags[cur.b],
                      args.selfdot[cur.a], args.selfdot[cur.b],
                      args.stddevs[cur.a], args.stddevs[cur.b],
                      args.lens[cur.a],    args.lens[cur.b]};
    const PlaneIn pl = PLANE ? PlaneIn{args.plane + p, n_pairs, args.n_plane} : PlaneIn{};
    epilogue_warp<true, PLANE>(prm, st, mom, fs, pl, dd, args.inv_d, lane, out);
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

int smem_optin() {
  static int bytes = 0;
  if (bytes == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
            cudaSuccess ||
        bytes <= 0)
      bytes = 48 * 1024;
  }
  return bytes;
}

// Launches one instantiation: G (pairs a warp) so that the grid is at
// most one wave of the warps the card holds at once, one pair a warp while
// they suffice.
template <typename T, int NV, bool NARROW, bool PLANE>
int launch_with(Args args, int smem, cudaStream_t st) {
  auto kern = pair_stats_kernel<T, NV, NARROW, PLANE>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  static int cached_smem = -1, per_sm = 0;
  if (smem != cached_smem) {
    const cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    cached_smem = smem;
  }
  const long long resident =
      static_cast<long long>(per_sm > 0 ? per_sm : 1) * kWarpsPerBlock * sm_count();
  const long long g = (args.n_pairs + resident - 1) / resident;
  if (g > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  args.group = static_cast<int>(g);
  const long long per_block = static_cast<long long>(kWarpsPerBlock) * g;
  const long long blocks = (args.n_pairs + per_block - 1) / per_block;
  kern<<<dim3(static_cast<unsigned>(blocks)), kThreads, smem, st>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool NARROW, bool PLANE>
int dispatch(const Args& args, int smem, cudaStream_t st) {
  const int row_bytes = args.d * static_cast<int>(sizeof(T));
  const bool aligned = reinterpret_cast<uintptr_t>(args.counts) % 16 == 0;
  // the register path: at most 32 counts a lane
  if (aligned && row_bytes % (kWarpSize * 16) == 0) {
    const int nv = row_bytes / (kWarpSize * 16);
    if (nv == 1) return launch_with<T, 1, NARROW, PLANE>(args, smem, st);
    if (nv == 2) return launch_with<T, 2, NARROW, PLANE>(args, smem, st);
    if constexpr (sizeof(T) == 2) {
      if (nv == 4) return launch_with<T, 4, NARROW, PLANE>(args, smem, st);
    }
  }
  // 16-byte loads need every lane slice to be whole, aligned vectors
  if (aligned && args.d % (kWarpSize * (16 / static_cast<int>(sizeof(T)))) == 0)
    return launch_with<T, 0, NARROW, PLANE>(args, smem, st);
  return launch_with<T, -1, NARROW, PLANE>(args, smem, st);
}

// The FULL kernel (full_kernel): S warps a pair, doubled while the pairs'
// warps still fit one wave of the resident warps and each thread keeps two
// groups of 4; a grid of at most the resident blocks, each block
// walking its pairs (so it stages the center row once).
template <typename T, bool PLANE>
int launch_full(Args args, int smem, cudaStream_t st) {
  auto kern = full_kernel<T, PLANE>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  static int cached_smem = -1, per_sm = 0;
  if (smem != cached_smem) {
    const cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    cached_smem = smem;
  }
  const long long resident = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sm_count();
  int split = 1;
  while (2 * split <= kWarpsPerBlock && 2 * split * kWarpSize * 8 <= args.d &&
         2 * args.n_pairs * split <= resident * kWarpsPerBlock)
    split *= 2;
  args.group = split;
  const int teams = kWarpsPerBlock / split;
  const long long want = (args.n_pairs + teams - 1) / teams;
  const long long blocks = want < resident ? want : resident;
  kern<<<dim3(static_cast<unsigned>(blocks)), kThreads, smem, st>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* counts, long long n_rows, int d, const void* a_idx,
           const void* b_idx, int center, long long n_pairs, const void* mags,
           const void* selfdot, const void* stddevs, const void* lens,
           const void* prm, int n_prm, double inv_d, int full, int plane,
           const void* plane_vals, int n_plane, int narrow, void* stats, void* dec,
           void* stream) {
  if (n_pairs <= 0) return static_cast<int>(cudaSuccess);
  if (d <= 0 || (dec != nullptr && n_prm < kHead) ||
      (full && (dec == nullptr || d % 4 != 0)) ||
      (plane && (dec == nullptr || plane_vals == nullptr || n_plane <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args args{};
  args.counts = counts;
  args.n_rows = n_rows;
  args.d = d;
  args.a_idx = static_cast<const long long*>(a_idx);
  args.b_idx = static_cast<const long long*>(b_idx);
  args.n_pairs = n_pairs;
  args.center = center;
  args.mags = static_cast<const double*>(mags);
  args.selfdot = static_cast<const double*>(selfdot);
  args.stddevs = static_cast<const double*>(stddevs);
  args.lens = static_cast<const double*>(lens);
  args.prm = static_cast<const double*>(prm);
  args.n_prm = n_prm;
  args.inv_d = inv_d;
  args.plane = static_cast<const double*>(plane_vals);
  args.n_plane = n_plane;
  args.stats = static_cast<long long*>(stats);
  args.dec = static_cast<double*>(dec);
  // shared memory: the parameters, then the center row, each where it
  // fits, then (FULL) the warps' slots
  const int slots = full ? kWarpsPerBlock * kSlots * 8 : 0;
  const int limit = smem_optin() - slots;
  const int prm_bytes = dec != nullptr ? (n_prm * 8 + 15) / 16 * 16 : 0;
  const long long row_bytes =
      center ? (static_cast<long long>(d) * sizeof(T) + 15) / 16 * 16 : 0;
  args.prm_shared = prm_bytes > 0 && prm_bytes <= limit;
  int smem = args.prm_shared ? prm_bytes : 0;
  args.center_shared = center && smem + row_bytes <= limit;
  if (args.center_shared) smem += static_cast<int>(row_bytes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (full)
    return plane ? launch_full<T, true>(args, smem + slots, st)
                 : launch_full<T, false>(args, smem + slots, st);
  if (plane)
    return narrow ? dispatch<T, true, true>(args, smem, st)
                  : dispatch<T, false, true>(args, smem, st);
  return narrow ? dispatch<T, true, false>(args, smem, st)
                : dispatch<T, false, false>(args, smem, st);
}

}  // namespace

extern "C" {

// The statistics alone (training tables, the smoke's oracle checks).
int mc2_pair_stats_u8(const void* counts, long long n_rows, int d,
                      const void* a_idx, const void* b_idx, int center,
                      long long n_pairs, int narrow, void* stats, void* stream) {
  return launch<uint8_t>(counts, n_rows, d, a_idx, b_idx, center, n_pairs,
                         nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0.0, 0,
                         0, nullptr, 0, narrow, stats, nullptr, stream);
}

int mc2_pair_stats_u16(const void* counts, long long n_rows, int d,
                       const void* a_idx, const void* b_idx, int center,
                       long long n_pairs, int narrow, void* stats, void* stream) {
  return launch<uint16_t>(counts, n_rows, d, a_idx, b_idx, center, n_pairs,
                          nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0.0, 0,
                          0, nullptr, 0, narrow, stats, nullptr, stream);
}

// The statistics and the classifier epilogue: stats [P, 3] int64 and dec
// [5, P] float64 (s, prob, dist, s_err, dist_err); full = 1 (the model has
// full-vector singles) launches the FULL instantiation, plane = 1 (it has
// plane singles, their values and bounds [2, n_plane, P] in plane_vals) the
// PLANE one.
int mc2_pair_decision_u8(const void* counts, long long n_rows, int d,
                         const void* a_idx, const void* b_idx, int center,
                         long long n_pairs, const void* mags, const void* selfdot,
                         const void* stddevs, const void* lens, const void* prm,
                         int n_prm, double inv_d, int full, int plane,
                         const void* plane_vals, int n_plane, int narrow, void* stats,
                         void* dec, void* stream) {
  return launch<uint8_t>(counts, n_rows, d, a_idx, b_idx, center, n_pairs, mags,
                         selfdot, stddevs, lens, prm, n_prm, inv_d, full, plane,
                         plane_vals, n_plane, narrow, stats, dec, stream);
}

int mc2_pair_decision_u16(const void* counts, long long n_rows, int d,
                          const void* a_idx, const void* b_idx, int center,
                          long long n_pairs, const void* mags, const void* selfdot,
                          const void* stddevs, const void* lens, const void* prm,
                          int n_prm, double inv_d, int full, int plane,
                          const void* plane_vals, int n_plane, int narrow, void* stats,
                          void* dec, void* stream) {
  return launch<uint16_t>(counts, n_rows, d, a_idx, b_idx, center, n_pairs, mags,
                          selfdot, stddevs, lens, prm, n_prm, inv_d, full, plane,
                          plane_vals, n_plane, narrow, stats, dec, stream);
}

}  // extern "C"
