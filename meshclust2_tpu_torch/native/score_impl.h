// Shared native scoring machinery (header-only, namespace mc2).
//
// Used by score.cpp (the batch entry points score_block / raw_singles /
// mean_shift_argmin) and accumulate.cpp (the full accumulate-phase driver).
// The semantics mirror the reference's Feature.cpp / Predictor.cpp decision
// chain exactly; see score.cpp's header comment for the FUSED vs EXACT
// design and the borderline-recheck contract.
#pragma once

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cassert>
#include <cstring>
#include <type_traits>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace mc2 {

template <typename T>
struct PointsView {
    const T* counts;
    const int64_t* mags;
    const int64_t* lengths;
    const double* stddevs;
    const double* self_dots;  // sum of squared counts per point (may be null)
    int64_t dim;
    const T* row(int64_t i) const { return counts + i * dim; }
};

// ---- exact per-feature loops (Feature.cpp accumulation order) -------------

template <typename T>
double f_hellinger(const PointsView<T>& v, int64_t a, int64_t b) {
    const T* p = v.row(a);
    const T* q = v.row(b);
    double ap = (double)v.mags[a] / v.dim, aq = (double)v.mags[b] / v.dim;
    double sum = 0;
    for (int64_t i = 0; i < v.dim; i++) {
        double d = std::sqrt(p[i] / ap) - std::sqrt(q[i] / aq);
        sum += d * d;
    }
    return std::sqrt(2 * sum);
}

template <typename T>
double f_manhattan(const PointsView<T>& v, int64_t a, int64_t b) {
    const T* p = v.row(a);
    const T* q = v.row(b);
    int64_t sum = 0;
    for (int64_t i = 0; i < v.dim; i++)
        sum += p[i] > q[i] ? (int64_t)p[i] - q[i] : (int64_t)q[i] - p[i];
    return (double)sum;
}

template <typename T>
double f_euclidean(const PointsView<T>& v, int64_t a, int64_t b) {
    const T* p = v.row(a);
    const T* q = v.row(b);
    uint64_t sum = 0;
    for (int64_t i = 0; i < v.dim; i++) {
        int64_t d = (int64_t)p[i] - (int64_t)q[i];
        sum += (uint64_t)(d * d);
    }
    return std::sqrt((double)sum);
}

template <typename T>
double f_chi2(const PointsView<T>& v, int64_t a, int64_t b) {
    const T* p = v.row(a);
    const T* q = v.row(b);
    double sum = 0;
    for (int64_t i = 0; i < v.dim; i++) {
        double d = (double)p[i] - (double)q[i];
        sum += d * d / ((double)p[i] + (double)q[i]);
    }
    return sum;
}

template <typename T>
double f_normvec(const PointsView<T>& v, int64_t a, int64_t b) {
    const T* p = v.row(a);
    const T* q = v.row(b);
    uint64_t dot = 0, d1 = 0, d2 = 0;
    for (int64_t i = 0; i < v.dim; i++) {
        dot += (uint64_t)p[i] * q[i];
        d1 += (uint64_t)p[i] * p[i];
        d2 += (uint64_t)q[i] * q[i];
    }
    return (double)dot / std::sqrt((double)d1 * (double)d2);
}

template <typename T>
double f_harmonic(const PointsView<T>& v, int64_t a, int64_t b) {
    const T* p = v.row(a);
    const T* q = v.row(b);
    double sum = 0;
    for (int64_t i = 0; i < v.dim; i++)
        sum += (double)((uint64_t)p[i] * q[i]) / ((double)p[i] + (double)q[i]);
    return 2 * sum;
}

template <typename T>
double f_jefferey(const PointsView<T>& v, int64_t a, int64_t b) {
    const T* p = v.row(a);
    const T* q = v.row(b);
    double mp = (double)v.mags[a], mq = (double)v.mags[b];
    double sum = 0;
    for (int64_t i = 0; i < v.dim; i++) {
        double pp = p[i] / mp, pq = q[i] / mq;
        sum += (pp - pq) * std::log(pp / pq);
    }
    return sum;
}

template <typename T>
double f_kdiv(const PointsView<T>& v, int64_t a, int64_t b) {
    const T* p = v.row(a);
    const T* q = v.row(b);
    double mp = (double)v.mags[a], mq = (double)v.mags[b];
    double sum = 0;
    for (int64_t i = 0; i < v.dim; i++) {
        double pp = p[i] / mp, pq = q[i] / mq;
        sum += pp * std::log(pp / (0.5 * (pp + pq)));
    }
    return sum;
}

template <typename T>
double f_pearson(const PointsView<T>& v, int64_t a, int64_t b) {
    const T* p = v.row(a);
    const T* q = v.row(b);
    double ap = (double)v.mags[a] / v.dim, aq = (double)v.mags[b] / v.dim;
    double dot = 0, np_ = 0, nq = 0;
    for (int64_t i = 0; i < v.dim; i++) {
        double dp = p[i] - ap, dq = q[i] - aq;
        np_ += dp * dp;
        nq += dq * dq;
        dot += dp * dq;
    }
    return dot / std::sqrt(np_ * nq);
}

template <typename T>
double f_sqchord(const PointsView<T>& v, int64_t a, int64_t b) {
    const T* p = v.row(a);
    const T* q = v.row(b);
    double sum = 0;
    for (int64_t i = 0; i < v.dim; i++)
        sum += (double)p[i] + q[i] - 2 * std::sqrt((double)p[i] * q[i]);
    return sum;
}

template <typename T>
double f_klcond(const PointsView<T>& v, int64_t a, int64_t b) {
    const T* p = v.row(a);
    const T* q = v.row(b);
    uint64_t s4p = 0, s4q = 0;
    double op = 0, oq = 0;
    for (int64_t i = 0; i < v.dim; i++) {
        s4p += p[i];
        s4q += q[i];
        if (i % 4 == 3) {
            double ip = 0, iq = 0;
            for (int64_t j = i - 3; j <= i; j++) {
                double cp = (double)p[j] / s4p, cq = (double)q[j] / s4q;
                double lg = std::log(cp / cq);
                ip += cp * lg;
                iq += -cq * lg;
            }
            op += s4p * ip;
            oq += s4q * iq;
            s4p = s4q = 0;
        }
    }
    return (op / v.mags[a] + oq / v.mags[b]) / 2.0;
}

template <typename T>
double f_intersection(const PointsView<T>& v, int64_t a, int64_t b) {
    const T* p = v.row(a);
    const T* q = v.row(b);
    uint64_t dist = 0;
    for (int64_t i = 0; i < v.dim; i++)
        dist += 2 * (uint64_t)std::min(p[i], q[i]);
    return (double)dist / (double)(v.mags[a] + v.mags[b]);
}

template <typename T>
double f_emd(const PointsView<T>& v, int64_t a, int64_t b) {
    const T* p = v.row(a);
    const T* q = v.row(b);
    uint64_t cp = 0, cq = 0, dist = 0;
    for (int64_t i = 0; i < v.dim; i++) {
        cp += p[i];
        cq += q[i];
        dist += cp > cq ? cp - cq : cq - cp;
    }
    return (double)dist;
}

template <typename T>
double f_lengthd(const PointsView<T>& v, int64_t a, int64_t b) {
    int64_t lp = v.lengths[a], lq = v.lengths[b];
    return (double)(lp > lq ? lp - lq : lq - lp);
}

template <typename T>
double f_mismatch(const PointsView<T>& v, int64_t a, int64_t b) {
    const T* p = v.row(a);
    const T* q = v.row(b);
    uint64_t sum = 0;
    for (int64_t i = 0; i < v.dim; i++) sum += (p[i] != q[i]);
    return (double)sum;
}

template <typename T>
double f_canberra(const PointsView<T>& v, int64_t a, int64_t b) {
    const T* p = v.row(a);
    const T* q = v.row(b);
    double sum = 0;
    for (int64_t i = 0; i < v.dim; i++) {
        int64_t num = p[i] > q[i] ? (int64_t)p[i] - q[i] : (int64_t)q[i] - p[i];
        sum += (double)num / ((double)p[i] + q[i]);
    }
    return sum;
}

template <typename T>
double f_kul1(const PointsView<T>& v, int64_t a, int64_t b) {
    const T* p = v.row(a);
    const T* q = v.row(b);
    double sum = 0;
    for (int64_t i = 0; i < v.dim; i++) {
        int64_t num = p[i] > q[i] ? (int64_t)p[i] - q[i] : (int64_t)q[i] - p[i];
        sum += (double)num / std::min(p[i], q[i]);
    }
    return sum;
}

template <typename T>
double f_kul2(const PointsView<T>& v, int64_t a, int64_t b) {
    const T* p = v.row(a);
    const T* q = v.row(b);
    uint64_t min_sum = 0;
    for (int64_t i = 0; i < v.dim; i++) min_sum += std::min(p[i], q[i]);
    double ap = (double)v.mags[a] / v.dim, aq = (double)v.mags[b] / v.dim;
    double coeff = v.dim * (ap + aq) / (2 * ap * aq);
    return coeff * min_sum;
}

template <typename T>
double f_simratio(const PointsView<T>& v, int64_t a, int64_t b) {
    const T* p = v.row(a);
    const T* q = v.row(b);
    uint64_t dot = 0, norm2 = 0;
    for (int64_t i = 0; i < v.dim; i++) {
        int64_t diff = (int64_t)p[i] - (int64_t)q[i];
        dot += (uint64_t)p[i] * q[i];
        norm2 += (uint64_t)(diff * diff);
    }
    return (double)dot / ((double)dot + std::sqrt((double)norm2));
}

template <typename T>
double f_js(const PointsView<T>& v, int64_t a, int64_t b) {
    const T* p = v.row(a);
    const T* q = v.row(b);
    double mp = (double)v.mags[a], mq = (double)v.mags[b];
    double sum = 0;
    for (int64_t i = 0; i < v.dim; i++) {
        double pp = p[i] / mp, pq = q[i] / mq;
        double avg = 0.5 * (pp + pq);
        sum += pp * std::log(pp / avg) + pq * std::log(pq / avg);
    }
    return sum / 2;
}

template <typename T>
double f_d2z(const PointsView<T>& v, int64_t a, int64_t b) {
    const T* p = v.row(a);
    const T* q = v.row(b);
    double ap = (double)v.mags[a] / v.dim, aq = (double)v.mags[b] / v.dim;
    double sp = v.stddevs[a], sq = v.stddevs[b];
    double sum = 0;
    for (int64_t i = 0; i < v.dim; i++)
        sum += ((p[i] - ap) / sp) * ((q[i] - aq) / sq);
    return sum;
}

template <typename T>
double f_euclidean_z(const PointsView<T>& v, int64_t a, int64_t b) {
    const T* p = v.row(a);
    const T* q = v.row(b);
    double ap = (double)v.mags[a] / v.dim, aq = (double)v.mags[b] / v.dim;
    double sp = v.stddevs[a], sq = v.stddevs[b];
    double sum = 0;
    for (int64_t i = 0; i < v.dim; i++) {
        double d = (p[i] - ap) / sp - (q[i] - aq) / sq;
        sum += d * d;
    }
    return std::sqrt(sum);
}

template <typename T>
double f_jaccard(const PointsView<T>& v, int64_t a, int64_t b) {
    const T* p = v.row(a);
    const T* q = v.row(b);
    uint64_t sum = 0;
    for (int64_t i = 0; i < v.dim; i++) sum += (p[i] == q[i] && p[i] > 1);
    return (double)sum / v.dim;
}

template <typename T>
using feat_fn = double (*)(const PointsView<T>&, int64_t, int64_t);

template <typename T>
feat_fn<T> dispatch(int32_t id) {
    switch (id) {
        case 1: return f_hellinger<T>;
        case 2: return f_manhattan<T>;
        case 3: return f_euclidean<T>;
        case 4: return f_chi2<T>;
        case 5: return f_normvec<T>;
        case 6: return f_harmonic<T>;
        case 7: return f_jefferey<T>;
        case 8: return f_kdiv<T>;
        case 9: return f_pearson<T>;
        case 10: return f_sqchord<T>;
        case 11: return f_klcond<T>;
        case 13: return f_intersection<T>;
        case 15: return f_d2z<T>;
        case 17: return f_euclidean_z<T>;
        case 18: return f_emd<T>;
        case 20: return f_jaccard<T>;
        case 21: return f_lengthd<T>;
        case 24: return f_mismatch<T>;
        case 25: return f_canberra<T>;
        case 26: return f_kul1<T>;
        case 27: return f_kul2<T>;
        case 28: return f_simratio<T>;
        case 29: return f_js<T>;
        default: return nullptr;
    }
}

// features derivable from the fused statistics
inline bool fused_derivable(int32_t id) {
    switch (id) {
        case 2: case 3: case 5: case 9: case 13: case 15: case 17:
        case 18: case 21: case 27: case 28:
            return true;
        default:
            return false;
    }
}

struct ModelSpec {
    const int32_t* single_ids;
    const double* mins;
    const double* maxs;
    const uint8_t* is_sim;
    int32_t n_singles;
    const int32_t* combo_kinds;
    const int32_t* combo_idx0;
    const int32_t* combo_idx1;
    int32_t n_combos;
    const double* weights;
    double bias;
    int32_t raw_sum;  // 1: emit the linear sum (regression head,
                      // Predictor.cpp:283-300) instead of logistic+bias
};

inline void decide(const ModelSpec& m, const double* cache, double* out_prob,
                   double* out_dist) {
    double norm[64];
    for (int32_t s = 0; s < m.n_singles; s++) {
        double val = (cache[s] - m.mins[s]) / (m.maxs[s] - m.mins[s]);
        norm[s] = m.is_sim[s] ? val : 1.0 - val;
    }
    double sum = m.weights[0];
    double dist = 0;
    for (int32_t c = 0; c < m.n_combos; c++) {
        double x = norm[m.combo_idx0[c]];
        double y = m.combo_idx1[c] >= 0 ? norm[m.combo_idx1[c]] : 1.0;
        double val;
        switch (m.combo_kinds[c]) {
            case 0: val = x * y; break;
            case 1: val = x * y * y; break;
            case 2: val = x * x * y; break;
            default: val = x * x * y * y; break;
        }
        if (c == 0) dist = val;
        sum += m.weights[c + 1] * val;
    }
    *out_prob = m.raw_sum ? sum : 1.0 / (1.0 + std::exp(-sum)) + m.bias;
    *out_dist = dist;
}

template <typename T>
void exact_pair(const PointsView<T>& v, const ModelSpec& m, feat_fn<T>* fns,
                int64_t a, int64_t b, double* out_prob, double* out_dist) {
    double cache[64];
    for (int32_t s = 0; s < m.n_singles; s++) cache[s] = fns[s](v, a, b);
    decide(m, cache, out_prob, out_dist);
}

// one fused pass over a pair: integer sufficient statistics
template <typename T>
inline void fused_stats(const T* p, const T* q, int64_t dim, bool need_logs,
                        double mp, double mq, uint64_t* o_summin,
                        uint64_t* o_dot, uint64_t* o_emd, double* o_jd,
                        double* o_js) {
    uint64_t summin = 0, dot = 0, emd = 0;
    uint64_t cp = 0, cq = 0;
    double jd = 0, js = 0;
    if (need_logs) {
        for (int64_t i = 0; i < dim; i++) {
            uint64_t pi = p[i], qi = q[i];
            summin += std::min(pi, qi);
            dot += pi * qi;
            cp += pi;
            cq += qi;
            emd += cp > cq ? cp - cq : cq - cp;
            double pp = pi / mp, pq = qi / mq;
            double avg = 0.5 * (pp + pq);
            jd += (pp - pq) * std::log(pp / pq);
            js += pp * std::log(pp / avg) + pq * std::log(pq / avg);
        }
    } else {
        for (int64_t i = 0; i < dim; i++) {
            uint64_t pi = p[i], qi = q[i];
            summin += std::min(pi, qi);
            dot += pi * qi;
            cp += pi;
            cq += qi;
            emd += cp > cq ? cp - cq : cq - cp;
        }
    }
    *o_summin = summin;
    *o_dot = dot;
    *o_emd = emd;
    *o_jd = jd;
    *o_js = js / 2;
}

// EMD = sum_i |prefix_i(p - q)|.  The prefix is a loop-carried dependency;
// the AVX2 kernels process 16 elements per step with the block-local prefix
// computed in i16 lanes (16 u8 diffs bound the local prefix by 4080, exact
// in i16), then widen to i32 and chain through the running base.  Per-lane
// i32 abs accumulation is exact for dim <= 8192 (|prefix| <= 255*dim with
// 2*dim/16 terms per lane keeps totals under 2^31); larger dims take the
// scalar path below (dim = 4^k <= 65536 only at k = 8, where u8 histograms
// are near-saturated anyway and the fused path is rarely selected).
#if defined(__AVX2__)

// one in-lane inclusive prefix step over 16 i16 diffs: after the three
// shift-adds each 128-bit lane holds its own local prefix of 8 elements
static inline __m256i local_prefix16_epi16(__m256i d) {
    d = _mm256_add_epi16(d, _mm256_slli_si256(d, 2));
    d = _mm256_add_epi16(d, _mm256_slli_si256(d, 4));
    return _mm256_add_epi16(d, _mm256_slli_si256(d, 8));
}

static inline uint64_t emd_u8_avx2(const uint8_t* p, const uint8_t* q,
                                   int64_t dim) {
    uint64_t emd = 0;
    int64_t i = 0;
    int32_t prefix = 0;
    if (dim <= 8192) {
        __m256i base = _mm256_setzero_si256();
        __m256i acc = _mm256_setzero_si256();
        const __m256i seven = _mm256_set1_epi32(7);
        for (; i + 16 <= dim; i += 16) {
            __m256i pv = _mm256_cvtepu8_epi16(
                _mm_loadu_si128((const __m128i*)(p + i)));
            __m256i qv = _mm256_cvtepu8_epi16(
                _mm_loadu_si128((const __m128i*)(q + i)));
            __m256i d = local_prefix16_epi16(_mm256_sub_epi16(pv, qv));
            __m256i lo32 = _mm256_cvtepi16_epi32(_mm256_castsi256_si128(d));
            __m256i hi32 = _mm256_cvtepi16_epi32(_mm256_extracti128_si256(d, 1));
            __m256i pre_lo = _mm256_add_epi32(lo32, base);
            __m256i lo_tot = _mm256_permutevar8x32_epi32(pre_lo, seven);
            __m256i pre_hi = _mm256_add_epi32(hi32, lo_tot);
            base = _mm256_permutevar8x32_epi32(pre_hi, seven);
            acc = _mm256_add_epi32(acc, _mm256_abs_epi32(pre_lo));
            acc = _mm256_add_epi32(acc, _mm256_abs_epi32(pre_hi));
        }
        int32_t l8[8];
        _mm256_storeu_si256((__m256i*)l8, acc);
        for (int j = 0; j < 8; j++) emd += (uint64_t)(uint32_t)l8[j];
        prefix = _mm256_extract_epi32(base, 7);
    }
    for (; i < dim; i++) {
        prefix += (int32_t)p[i] - (int32_t)q[i];
        emd += (uint64_t)(prefix < 0 ? -prefix : prefix);
    }
    return emd;
}

// two interleaved EMD chains: the base update is a serial dependency, so a
// single chain leaves execution ports idle — pairing two independent pairs
// in one loop hides that latency (~1.2x on top of the i16 step).
static inline void emd_u8_avx2_x2(const uint8_t* p0, const uint8_t* q0,
                                  const uint8_t* p1, const uint8_t* q1,
                                  int64_t dim, uint64_t* e0, uint64_t* e1) {
    if (dim > 8192) {
        *e0 = emd_u8_avx2(p0, q0, dim);
        *e1 = emd_u8_avx2(p1, q1, dim);
        return;
    }
    __m256i base0 = _mm256_setzero_si256(), base1 = _mm256_setzero_si256();
    __m256i acc0 = _mm256_setzero_si256(), acc1 = _mm256_setzero_si256();
    const __m256i seven = _mm256_set1_epi32(7);
    int64_t i = 0;
    for (; i + 16 <= dim; i += 16) {
        __m256i pv0 = _mm256_cvtepu8_epi16(
            _mm_loadu_si128((const __m128i*)(p0 + i)));
        __m256i qv0 = _mm256_cvtepu8_epi16(
            _mm_loadu_si128((const __m128i*)(q0 + i)));
        __m256i pv1 = _mm256_cvtepu8_epi16(
            _mm_loadu_si128((const __m128i*)(p1 + i)));
        __m256i qv1 = _mm256_cvtepu8_epi16(
            _mm_loadu_si128((const __m128i*)(q1 + i)));
        __m256i d0 = local_prefix16_epi16(_mm256_sub_epi16(pv0, qv0));
        __m256i d1 = local_prefix16_epi16(_mm256_sub_epi16(pv1, qv1));
        __m256i lo0 = _mm256_cvtepi16_epi32(_mm256_castsi256_si128(d0));
        __m256i hi0 = _mm256_cvtepi16_epi32(_mm256_extracti128_si256(d0, 1));
        __m256i lo1 = _mm256_cvtepi16_epi32(_mm256_castsi256_si128(d1));
        __m256i hi1 = _mm256_cvtepi16_epi32(_mm256_extracti128_si256(d1, 1));
        __m256i pl0 = _mm256_add_epi32(lo0, base0);
        __m256i pl1 = _mm256_add_epi32(lo1, base1);
        __m256i lt0 = _mm256_permutevar8x32_epi32(pl0, seven);
        __m256i lt1 = _mm256_permutevar8x32_epi32(pl1, seven);
        __m256i ph0 = _mm256_add_epi32(hi0, lt0);
        __m256i ph1 = _mm256_add_epi32(hi1, lt1);
        base0 = _mm256_permutevar8x32_epi32(ph0, seven);
        base1 = _mm256_permutevar8x32_epi32(ph1, seven);
        acc0 = _mm256_add_epi32(acc0, _mm256_abs_epi32(pl0));
        acc0 = _mm256_add_epi32(acc0, _mm256_abs_epi32(ph0));
        acc1 = _mm256_add_epi32(acc1, _mm256_abs_epi32(pl1));
        acc1 = _mm256_add_epi32(acc1, _mm256_abs_epi32(ph1));
    }
    int32_t l0[8], l1[8];
    _mm256_storeu_si256((__m256i*)l0, acc0);
    _mm256_storeu_si256((__m256i*)l1, acc1);
    uint64_t s0 = 0, s1 = 0;
    for (int j = 0; j < 8; j++) {
        s0 += (uint32_t)l0[j];
        s1 += (uint32_t)l1[j];
    }
    int32_t pr0 = _mm256_extract_epi32(base0, 7);
    int32_t pr1 = _mm256_extract_epi32(base1, 7);
    for (; i < dim; i++) {
        pr0 += (int32_t)p0[i] - (int32_t)q0[i];
        s0 += (uint64_t)(pr0 < 0 ? -pr0 : pr0);
        pr1 += (int32_t)p1[i] - (int32_t)q1[i];
        s1 += (uint64_t)(pr1 < 0 ? -pr1 : pr1);
    }
    *e0 = s0;
    *e1 = s1;
}
#endif

// EMD entry points used by the fused path (scalar fallback without AVX2)
static inline uint64_t emd_u8(const uint8_t* p, const uint8_t* q,
                              int64_t dim) {
#if defined(__AVX2__)
    return emd_u8_avx2(p, q, dim);
#else
    uint64_t emd = 0;
    int32_t prefix = 0;
    for (int64_t i = 0; i < dim; i++) {
        prefix += (int32_t)p[i] - (int32_t)q[i];
        emd += (uint64_t)(prefix < 0 ? -prefix : prefix);
    }
    return emd;
#endif
}

static inline void emd_u8_x2(const uint8_t* p0, const uint8_t* q0,
                             const uint8_t* p1, const uint8_t* q1,
                             int64_t dim, uint64_t* e0, uint64_t* e1) {
#if defined(__AVX2__)
    emd_u8_avx2_x2(p0, q0, p1, q1, dim, e0, e1);
#else
    *e0 = emd_u8(p0, q0, dim);
    *e1 = emd_u8(p1, q1, dim);
#endif
}

// ---- AVX-512 single-pass min/dot/EMD --------------------------------------
// One fused loop computes all three integer statistics per pair, reusing the
// i16 widenings for both the dot (VNNI dpwssd) and the EMD prefix: measured
// ~13-15% faster than the separate min/dot + EMD passes at dim 1024-4096 on
// a Sapphire Rapids host, bit-exact.  The 32-element i16 local prefix is
// exact (|local| <= 32*255 = 8160 < 2^15); dot i32 lanes stay under
// 255*255*2*(8192/32) < 2^31; the EMD i32 abs accumulation keeps the same
// dim <= 8192 envelope as the AVX2 kernel above.
#if defined(__AVX512BW__) && defined(__AVX512VNNI__)
#define MC2_FUSED512 1

// in-sublane (128-bit) inclusive prefix over 8 i16 lanes each
static inline __m512i local_prefix32_epi16(__m512i d) {
    d = _mm512_add_epi16(d, _mm512_bslli_epi128(d, 2));
    d = _mm512_add_epi16(d, _mm512_bslli_epi128(d, 4));
    return _mm512_add_epi16(d, _mm512_bslli_epi128(d, 8));
}

// Hillis-Steele chaining of the 4 sublane totals: step 1 adds the previous
// sublane's total (i16 lane 7/15/23) to sublanes 1-3, step 2 adds the
// total-from-two-back (lane 7/15 of the step-1 result) to sublanes 2-3.
static inline __m512i fused512_chain_idx1() {
    alignas(64) static const int16_t v[32] = {
        0, 0, 0, 0, 0, 0, 0, 0, 7, 7, 7, 7, 7, 7, 7, 7,
        15, 15, 15, 15, 15, 15, 15, 15, 23, 23, 23, 23, 23, 23, 23, 23};
    return _mm512_load_si512(v);
}
static inline __m512i fused512_chain_idx2() {
    alignas(64) static const int16_t v[32] = {
        0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
        7, 7, 7, 7, 7, 7, 7, 7, 15, 15, 15, 15, 15, 15, 15, 15};
    return _mm512_load_si512(v);
}

static inline void fused_u8_avx512(const uint8_t* p, const uint8_t* q,
                                   int64_t dim, uint64_t* o_min,
                                   uint64_t* o_dot, uint64_t* o_emd) {
    uint64_t summin = 0, dot = 0, emd = 0;
    int64_t i = 0;
    int32_t prefix = 0;
    if (dim <= 8192) {
        __m512i zero = _mm512_setzero_si512();
        __m256i zero256 = _mm256_setzero_si256();
        __m512i base = zero, acc = zero, dot_acc = zero;
        __m256i min_acc = zero256;
        const __m512i idx1 = fused512_chain_idx1();
        const __m512i idx2 = fused512_chain_idx2();
        const __mmask32 m1 = 0xFFFFFF00;  // sublanes 1..3
        const __mmask32 m2 = 0xFFFF0000;  // sublanes 2..3
        const __m512i last = _mm512_set1_epi32(15);
        for (; i + 32 <= dim; i += 32) {
            __m256i pb = _mm256_loadu_si256((const __m256i*)(p + i));
            __m256i qb = _mm256_loadu_si256((const __m256i*)(q + i));
            min_acc = _mm256_add_epi64(
                min_acc, _mm256_sad_epu8(_mm256_min_epu8(pb, qb), zero256));
            __m512i pv = _mm512_cvtepu8_epi16(pb);
            __m512i qv = _mm512_cvtepu8_epi16(qb);
            dot_acc = _mm512_dpwssd_epi32(dot_acc, pv, qv);
            __m512i d = local_prefix32_epi16(_mm512_sub_epi16(pv, qv));
            d = _mm512_add_epi16(
                d, _mm512_maskz_permutexvar_epi16(m1, idx1, d));
            d = _mm512_add_epi16(
                d, _mm512_maskz_permutexvar_epi16(m2, idx2, d));
            __m512i lo = _mm512_cvtepi16_epi32(_mm512_castsi512_si256(d));
            __m512i hi =
                _mm512_cvtepi16_epi32(_mm512_extracti64x4_epi64(d, 1));
            __m512i pl = _mm512_add_epi32(lo, base);
            __m512i ph = _mm512_add_epi32(hi, base);
            base = _mm512_permutexvar_epi32(last, ph);
            acc = _mm512_add_epi32(acc, _mm512_abs_epi32(pl));
            acc = _mm512_add_epi32(acc, _mm512_abs_epi32(ph));
        }
        uint64_t mn4[4];
        _mm256_storeu_si256((__m256i*)mn4, min_acc);
        summin = mn4[0] + mn4[1] + mn4[2] + mn4[3];
        int32_t dl[16];
        _mm512_storeu_si512(dl, dot_acc);
        int64_t dtot = 0;
        for (int j = 0; j < 16; j++) dtot += (int64_t)(uint32_t)dl[j];
        dot = (uint64_t)dtot;
        int32_t al[16];
        _mm512_storeu_si512(al, acc);
        for (int j = 0; j < 16; j++) emd += (uint64_t)(uint32_t)al[j];
        prefix = _mm_cvtsi128_si32(_mm512_castsi512_si128(base));
    }
    for (; i < dim; i++) {
        uint64_t pi = p[i], qi = q[i];
        summin += pi < qi ? pi : qi;
        dot += pi * qi;
        prefix += (int32_t)p[i] - (int32_t)q[i];
        emd += (uint64_t)(prefix < 0 ? -prefix : prefix);
    }
    *o_min = summin;
    *o_dot = dot;
    *o_emd = emd;
}

// two pairs interleaved in one loop (hides the serial EMD base update; fits
// comfortably in the 32 zmm registers — the AVX2 equivalent spilled)
static inline void fused_u8_avx512_x2(
    const uint8_t* p0, const uint8_t* q0, const uint8_t* p1,
    const uint8_t* q1, int64_t dim, uint64_t* o_min0, uint64_t* o_dot0,
    uint64_t* o_emd0, uint64_t* o_min1, uint64_t* o_dot1, uint64_t* o_emd1) {
    if (dim > 8192) {
        fused_u8_avx512(p0, q0, dim, o_min0, o_dot0, o_emd0);
        fused_u8_avx512(p1, q1, dim, o_min1, o_dot1, o_emd1);
        return;
    }
    __m512i zero = _mm512_setzero_si512();
    __m256i zero256 = _mm256_setzero_si256();
    __m512i base0 = zero, acc0 = zero, dot_acc0 = zero;
    __m512i base1 = zero, acc1 = zero, dot_acc1 = zero;
    __m256i min_acc0 = zero256, min_acc1 = zero256;
    const __m512i idx1 = fused512_chain_idx1();
    const __m512i idx2 = fused512_chain_idx2();
    const __mmask32 m1 = 0xFFFFFF00;
    const __mmask32 m2 = 0xFFFF0000;
    const __m512i last = _mm512_set1_epi32(15);
    int64_t i = 0;
    for (; i + 32 <= dim; i += 32) {
        __m256i pb0 = _mm256_loadu_si256((const __m256i*)(p0 + i));
        __m256i qb0 = _mm256_loadu_si256((const __m256i*)(q0 + i));
        __m256i pb1 = _mm256_loadu_si256((const __m256i*)(p1 + i));
        __m256i qb1 = _mm256_loadu_si256((const __m256i*)(q1 + i));
        min_acc0 = _mm256_add_epi64(
            min_acc0, _mm256_sad_epu8(_mm256_min_epu8(pb0, qb0), zero256));
        min_acc1 = _mm256_add_epi64(
            min_acc1, _mm256_sad_epu8(_mm256_min_epu8(pb1, qb1), zero256));
        __m512i pv0 = _mm512_cvtepu8_epi16(pb0);
        __m512i qv0 = _mm512_cvtepu8_epi16(qb0);
        __m512i pv1 = _mm512_cvtepu8_epi16(pb1);
        __m512i qv1 = _mm512_cvtepu8_epi16(qb1);
        dot_acc0 = _mm512_dpwssd_epi32(dot_acc0, pv0, qv0);
        dot_acc1 = _mm512_dpwssd_epi32(dot_acc1, pv1, qv1);
        __m512i d0 = local_prefix32_epi16(_mm512_sub_epi16(pv0, qv0));
        __m512i d1 = local_prefix32_epi16(_mm512_sub_epi16(pv1, qv1));
        d0 = _mm512_add_epi16(d0,
                              _mm512_maskz_permutexvar_epi16(m1, idx1, d0));
        d1 = _mm512_add_epi16(d1,
                              _mm512_maskz_permutexvar_epi16(m1, idx1, d1));
        d0 = _mm512_add_epi16(d0,
                              _mm512_maskz_permutexvar_epi16(m2, idx2, d0));
        d1 = _mm512_add_epi16(d1,
                              _mm512_maskz_permutexvar_epi16(m2, idx2, d1));
        __m512i lo0 = _mm512_cvtepi16_epi32(_mm512_castsi512_si256(d0));
        __m512i hi0 = _mm512_cvtepi16_epi32(_mm512_extracti64x4_epi64(d0, 1));
        __m512i lo1 = _mm512_cvtepi16_epi32(_mm512_castsi512_si256(d1));
        __m512i hi1 = _mm512_cvtepi16_epi32(_mm512_extracti64x4_epi64(d1, 1));
        __m512i pl0 = _mm512_add_epi32(lo0, base0);
        __m512i ph0 = _mm512_add_epi32(hi0, base0);
        __m512i pl1 = _mm512_add_epi32(lo1, base1);
        __m512i ph1 = _mm512_add_epi32(hi1, base1);
        base0 = _mm512_permutexvar_epi32(last, ph0);
        base1 = _mm512_permutexvar_epi32(last, ph1);
        acc0 = _mm512_add_epi32(acc0, _mm512_abs_epi32(pl0));
        acc0 = _mm512_add_epi32(acc0, _mm512_abs_epi32(ph0));
        acc1 = _mm512_add_epi32(acc1, _mm512_abs_epi32(pl1));
        acc1 = _mm512_add_epi32(acc1, _mm512_abs_epi32(ph1));
    }
    uint64_t mn4[4];
    _mm256_storeu_si256((__m256i*)mn4, min_acc0);
    uint64_t summin0 = mn4[0] + mn4[1] + mn4[2] + mn4[3];
    _mm256_storeu_si256((__m256i*)mn4, min_acc1);
    uint64_t summin1 = mn4[0] + mn4[1] + mn4[2] + mn4[3];
    int32_t dl[16];
    int64_t dtot = 0;
    _mm512_storeu_si512(dl, dot_acc0);
    for (int j = 0; j < 16; j++) dtot += (int64_t)(uint32_t)dl[j];
    uint64_t dot0 = (uint64_t)dtot;
    _mm512_storeu_si512(dl, dot_acc1);
    dtot = 0;
    for (int j = 0; j < 16; j++) dtot += (int64_t)(uint32_t)dl[j];
    uint64_t dot1 = (uint64_t)dtot;
    int32_t al[16];
    uint64_t emd0 = 0, emd1 = 0;
    _mm512_storeu_si512(al, acc0);
    for (int j = 0; j < 16; j++) emd0 += (uint64_t)(uint32_t)al[j];
    _mm512_storeu_si512(al, acc1);
    for (int j = 0; j < 16; j++) emd1 += (uint64_t)(uint32_t)al[j];
    int32_t pr0 = _mm_cvtsi128_si32(_mm512_castsi512_si128(base0));
    int32_t pr1 = _mm_cvtsi128_si32(_mm512_castsi512_si128(base1));
    for (; i < dim; i++) {
        uint64_t pi = p0[i], qi = q0[i];
        summin0 += pi < qi ? pi : qi;
        dot0 += pi * qi;
        pr0 += (int32_t)pi - (int32_t)qi;
        emd0 += (uint64_t)(pr0 < 0 ? -pr0 : pr0);
        pi = p1[i];
        qi = q1[i];
        summin1 += pi < qi ? pi : qi;
        dot1 += pi * qi;
        pr1 += (int32_t)pi - (int32_t)qi;
        emd1 += (uint64_t)(pr1 < 0 ? -pr1 : pr1);
    }
    *o_min0 = summin0;
    *o_dot0 = dot0;
    *o_emd0 = emd0;
    *o_min1 = summin1;
    *o_dot1 = dot1;
    *o_emd1 = emd1;
}
// four candidates against ONE broadcast row (the accumulate phase's
// candidates-vs-center shape): the center's load and i16 widening are
// shared across the four interleaved chains — ~13% over running the x2
// kernel twice at dim 1024 (still fits the 32 zmm registers; x8 spills).
// Bit-exact: integer statistics are exact regardless of interleave.
static inline void fused_u8_avx512_bcast_x4(
    const uint8_t* const* ps, const uint8_t* q, int64_t dim, uint64_t* o_min,
    uint64_t* o_dot, uint64_t* o_emd) {
    if (dim > 8192) {
        for (int t = 0; t < 4; t++)
            fused_u8_avx512(ps[t], q, dim, &o_min[t], &o_dot[t], &o_emd[t]);
        return;
    }
    __m512i zero = _mm512_setzero_si512();
    __m256i zero256 = _mm256_setzero_si256();
    __m512i base[4] = {zero, zero, zero, zero};
    __m512i acc[4] = {zero, zero, zero, zero};
    __m512i dot_acc[4] = {zero, zero, zero, zero};
    __m256i min_acc[4] = {zero256, zero256, zero256, zero256};
    const __m512i idx1 = fused512_chain_idx1();
    const __m512i idx2 = fused512_chain_idx2();
    const __mmask32 m1 = 0xFFFFFF00;
    const __mmask32 m2 = 0xFFFF0000;
    const __m512i last = _mm512_set1_epi32(15);
    int64_t i = 0;
    for (; i + 32 <= dim; i += 32) {
        __m256i qb = _mm256_loadu_si256((const __m256i*)(q + i));
        __m512i qv = _mm512_cvtepu8_epi16(qb);
        for (int t = 0; t < 4; t++) {
            __m256i pb = _mm256_loadu_si256((const __m256i*)(ps[t] + i));
            min_acc[t] = _mm256_add_epi64(
                min_acc[t], _mm256_sad_epu8(_mm256_min_epu8(pb, qb), zero256));
            __m512i pv = _mm512_cvtepu8_epi16(pb);
            dot_acc[t] = _mm512_dpwssd_epi32(dot_acc[t], pv, qv);
            __m512i d = local_prefix32_epi16(_mm512_sub_epi16(pv, qv));
            d = _mm512_add_epi16(d,
                                 _mm512_maskz_permutexvar_epi16(m1, idx1, d));
            d = _mm512_add_epi16(d,
                                 _mm512_maskz_permutexvar_epi16(m2, idx2, d));
            __m512i lo = _mm512_cvtepi16_epi32(_mm512_castsi512_si256(d));
            __m512i hi =
                _mm512_cvtepi16_epi32(_mm512_extracti64x4_epi64(d, 1));
            __m512i pl = _mm512_add_epi32(lo, base[t]);
            __m512i ph = _mm512_add_epi32(hi, base[t]);
            base[t] = _mm512_permutexvar_epi32(last, ph);
            acc[t] = _mm512_add_epi32(acc[t], _mm512_abs_epi32(pl));
            acc[t] = _mm512_add_epi32(acc[t], _mm512_abs_epi32(ph));
        }
    }
    for (int t = 0; t < 4; t++) {
        uint64_t mn4[4];
        _mm256_storeu_si256((__m256i*)mn4, min_acc[t]);
        uint64_t summin = mn4[0] + mn4[1] + mn4[2] + mn4[3];
        int32_t dl[16];
        _mm512_storeu_si512(dl, dot_acc[t]);
        int64_t dtot = 0;
        for (int j = 0; j < 16; j++) dtot += (int64_t)(uint32_t)dl[j];
        int32_t al[16];
        _mm512_storeu_si512(al, acc[t]);
        uint64_t emd = 0;
        for (int j = 0; j < 16; j++) emd += (uint64_t)(uint32_t)al[j];
        int32_t prefix = _mm_cvtsi128_si32(_mm512_castsi512_si128(base[t]));
        uint64_t dot = (uint64_t)dtot;
        for (int64_t r = i; r < dim; r++) {
            uint64_t pi = ps[t][r], qi = q[r];
            summin += pi < qi ? pi : qi;
            dot += pi * qi;
            prefix += (int32_t)pi - (int32_t)qi;
            emd += (uint64_t)(prefix < 0 ? -prefix : prefix);
        }
        o_min[t] = summin;
        o_dot[t] = dot;
        o_emd[t] = emd;
    }
}
#endif  // MC2_FUSED512

// jefferey / jensen-shannon terms for one pair (float64, reference
// accumulation order) — shared by the fused u8 paths
static inline void logs_u8(const uint8_t* p, const uint8_t* q, int64_t dim,
                           double mp, double mq, double* o_jd, double* o_js) {
    double jd = 0, js = 0;
    for (int64_t i = 0; i < dim; i++) {
        double pp = p[i] / mp, pq = q[i] / mq;
        double avg = 0.5 * (pp + pq);
        jd += (pp - pq) * std::log(pp / pq);
        js += pp * std::log(pp / avg) + pq * std::log(pq / avg);
    }
    *o_jd = jd;
    *o_js = js / 2;
}

// uint8 specialization: narrow accumulators the compiler can vectorize.
// min/sum/dot stay in uint32 (safe: dim <= 4^8 = 65536 with values <= 255
// keeps dot < 2^32); the EMD prefix scan is hand-vectorized when AVX2 is
// available.  need_emd gates the prefix scan (it is the expensive part).
static inline void fused_stats_u8(const uint8_t* p, const uint8_t* q,
                                  int64_t dim, bool need_logs, bool need_emd,
                                  double mp, double mq, uint64_t* o_summin,
                                  uint64_t* o_dot, uint64_t* o_emd,
                                  double* o_jd, double* o_js) {
    uint64_t summin = 0;
    uint64_t dot = 0;
    int64_t i0 = 0;
#if defined(__AVX2__)
    {
        __m256i zero = _mm256_setzero_si256();
        __m256i min_acc = zero;                 // 4 x u64 via SAD
        __m256i dot_acc = zero;                 // 8 x i32 via madd
        for (; i0 + 32 <= dim; i0 += 32) {
            __m256i pv = _mm256_loadu_si256((const __m256i*)(p + i0));
            __m256i qv = _mm256_loadu_si256((const __m256i*)(q + i0));
            // sum of per-byte minima: SAD against zero sums unsigned bytes
            __m256i mn = _mm256_min_epu8(pv, qv);
            min_acc = _mm256_add_epi64(min_acc, _mm256_sad_epu8(mn, zero));
            // dot: widen bytes to u16 and multiply-add into i32 lanes
            __m256i plo = _mm256_unpacklo_epi8(pv, zero);
            __m256i phi = _mm256_unpackhi_epi8(pv, zero);
            __m256i qlo = _mm256_unpacklo_epi8(qv, zero);
            __m256i qhi = _mm256_unpackhi_epi8(qv, zero);
            dot_acc = _mm256_add_epi32(dot_acc, _mm256_madd_epi16(plo, qlo));
            dot_acc = _mm256_add_epi32(dot_acc, _mm256_madd_epi16(phi, qhi));
        }
        uint64_t mn4[4];
        _mm256_storeu_si256((__m256i*)mn4, min_acc);
        summin = mn4[0] + mn4[1] + mn4[2] + mn4[3];
        int32_t d8[8];
        _mm256_storeu_si256((__m256i*)d8, dot_acc);
        for (int j = 0; j < 8; j++) dot += (uint64_t)(uint32_t)d8[j];
    }
#endif
    for (int64_t i = i0; i < dim; i++) {
        uint64_t pi = p[i], qi = q[i];
        summin += pi < qi ? pi : qi;
        dot += pi * qi;
    }
    uint64_t emd = 0;
    if (need_emd) emd = emd_u8(p, q, dim);
    double jd = 0, js = 0;
    if (need_logs) logs_u8(p, q, dim, mp, mq, &jd, &js);
    *o_summin = summin;
    *o_dot = dot;
    *o_emd = emd;
    *o_jd = jd;
    *o_js = js;
}

// Member closest to the float64 arithmetic-mean histogram
// (ClusterFactory.cpp:337-380 / DivergencePoint.cpp:54-66 with its
// truncating uint64 mag accumulation); first strict minimum wins.  Used by
// the accumulate and update phase drivers.
//
// The presummed variant takes the member-order running sum of the rows
// (exactly the prefix of the reference's own accumulation order, so the
// float64 mean is bit-identical) — the accumulate driver maintains it
// incrementally instead of re-summing the growing member list every
// re-centering round.  The rounded mean is hoisted out of the per-member
// loop (it only depends on the mean).  `allow_parallel` distributes the
// per-member distance pass over OpenMP threads for large clusters; the
// first-strict-minimum scan stays serial in member order, so the result is
// unchanged.  top_buf is resized to 2*dim (mean + rounded mean).
template <typename T>
int64_t closest_to_mean_presummed(const PointsView<T>& v,
                                  const std::vector<int64_t>& members,
                                  const double* sum,
                                  std::vector<double>* top_buf,
                                  bool allow_parallel = false) {
    int64_t dim = v.dim;
    if ((int64_t)top_buf->size() < 2 * dim) {
        // a resize would invalidate `sum` if it aliases the buffer (the
        // closest_to_mean wrapper passes sum = top_buf->data()); callers
        // that alias must pre-size to >= 2 * dim
        assert(sum < top_buf->data() ||
               sum >= top_buf->data() + top_buf->size());
        top_buf->resize(2 * dim);
    }
    double* top = top_buf->data();
    double* rt = top + dim;
    double n = (double)members.size();
    for (int64_t i = 0; i < dim; i++) {
        top[i] = sum[i] / n;  // sum may alias top: same-index read-then-write
        rt[i] = std::floor(top[i] + 0.5);
    }
    int64_t nm = (int64_t)members.size();
    auto dist_of = [&](int64_t r) {
        const T* row = v.row(r);
        uint64_t dist = 0, mag = 0;
        for (int64_t i = 0; i < dim; i++) {
            double cv = (double)row[i];
            dist += 2 * (uint64_t)std::min(cv, rt[i]);
            mag += (uint64_t)(cv + top[i]);
        }
        double frac = (double)dist / (double)mag;
        return 10000.0 * (1.0 - frac * frac);
    };
    if (allow_parallel && nm >= 64 && nm * dim >= ((int64_t)1 << 16)) {
        // thread-local scratch: re-centering runs once per accumulate
        // round, so a fresh heap allocation per call showed up at large
        // cluster sizes (ADVICE r2).  The raw pointer is hoisted BEFORE
        // the parallel region: `d` is thread_local, so naming it inside
        // the omp loop would resolve to each worker's own (empty) vector.
        static thread_local std::vector<double> d;
        d.resize(nm);
        double* dp = d.data();
#pragma omp parallel for schedule(static)
        for (int64_t k = 0; k < nm; k++) dp[k] = dist_of(members[k]);
        double best = dp[0];
        int64_t best_row = members[0];
        for (int64_t k = 1; k < nm; k++)
            if (dp[k] < best) {
                best = dp[k];
                best_row = members[k];
            }
        return best_row;
    }
    double best = 1e300;
    int64_t best_row = -1;
    for (int64_t r : members) {
        double d = dist_of(r);
        if (best_row < 0 || d < best) {
            best = d;
            best_row = r;
        }
    }
    return best_row;
}

template <typename T>
int64_t closest_to_mean(const PointsView<T>& v,
                        const std::vector<int64_t>& members,
                        std::vector<double>* top_buf) {
    int64_t dim = v.dim;
    if ((int64_t)top_buf->size() < 2 * dim) top_buf->resize(2 * dim);
    double* top = top_buf->data();
    for (int64_t i = 0; i < dim; i++) top[i] = 0.0;
    for (int64_t r : members) {
        const T* row = v.row(r);
        for (int64_t i = 0; i < dim; i++) top[i] += row[i];
    }
    return closest_to_mean_presummed(v, members, top, top_buf);
}

// Per-model dispatch state resolved once per batch (feature table, fused
// eligibility, which extra statistics the fused pass must carry).
template <typename T>
struct ScorePlan {
    feat_fn<T> fns[64];
    bool fused_ok = true;
    bool need_logs = false;
    bool need_emd = false;

    // returns false if a feature id has no native implementation
    bool build(const ModelSpec& m, const double* self_dots) {
        for (int32_t s = 0; s < m.n_singles; s++) {
            fns[s] = dispatch<T>(m.single_ids[s]);
            if (!fns[s]) return false;
            if (m.single_ids[s] == 18) need_emd = true;
            if (!fused_derivable(m.single_ids[s])) {
                if (m.single_ids[s] == 7 || m.single_ids[s] == 29)
                    need_logs = true;  // jefferey / jensen-shannon join the pass
                else
                    fused_ok = false;
            }
        }
        if (self_dots == nullptr) fused_ok = false;
        return true;
    }
};

// Score a batch of pairs (a_rows[i], b_rows[i * b_stride]) — b_stride 0
// broadcasts a single second row across the batch (the accumulate phase's
// candidates-vs-center shape).  Exact float64 reference decision semantics:
// the fused fast path plus the borderline recheck whose dist band is
// computed over THIS batch (matching the engine's per-window argmax
// semantics).
template <typename T>
void score_pairs(const PointsView<T>& v, const ModelSpec& m,
                 ScorePlan<T>& plan, const int64_t* a_rows,
                 const int64_t* b_rows, int64_t b_stride, int64_t n_pairs,
                 double* out_prob, double* out_dist) {
    const int64_t* lengths = v.lengths;
    const int64_t* mags = v.mags;
    const double* stddevs = v.stddevs;
    const double* self_dots = v.self_dots;
    int64_t dim = v.dim;

    if (!plan.fused_ok) {
#pragma omp parallel for schedule(dynamic, 16)
        for (int64_t pi = 0; pi < n_pairs; pi++)
            exact_pair(v, m, plan.fns, a_rows[pi], b_rows[pi * b_stride],
                       &out_prob[pi], &out_dist[pi]);
        return;
    }

    // per-pair fused statistics + derive + decide.  `have` says which
    // integer statistics the caller already computed: 0 none, 1 emd only,
    // 2 all of (summin, dot, emd).
    auto fused_one = [&](int64_t pi, uint64_t pre_min, uint64_t pre_dot,
                         uint64_t pre_emd, int have) {
        int64_t a = a_rows[pi], b = b_rows[pi * b_stride];
        double mp = (double)mags[a], mq = (double)mags[b];
        uint64_t summin, dot, emd;
        double jd = 0, js = 0;
        if constexpr (std::is_same<T, uint8_t>::value) {
            if (have == 2) {
                summin = pre_min;
                dot = pre_dot;
                emd = pre_emd;
                if (plan.need_logs)
                    logs_u8(v.row(a), v.row(b), dim, mp, mq, &jd, &js);
            } else {
                fused_stats_u8(v.row(a), v.row(b), dim, plan.need_logs,
                               plan.need_emd && have == 0, mp, mq, &summin,
                               &dot, &emd, &jd, &js);
                if (have == 1) emd = pre_emd;
            }
        } else {
            fused_stats(v.row(a), v.row(b), dim, plan.need_logs, mp, mq,
                        &summin, &dot, &emd, &jd, &js);
        }
        double selfA = self_dots[a], selfB = self_dots[b];
        double ap = mp / dim, aq = mq / dim;
        double norm2 = selfA + selfB - 2.0 * (double)dot;
        double cache[64];
        for (int32_t s = 0; s < m.n_singles; s++) {
            switch (m.single_ids[s]) {
                case 2:  // manhattan = magA + magB - 2*summin
                    cache[s] = (double)(mags[a] + mags[b] - 2 * (int64_t)summin);
                    break;
                case 3:
                    cache[s] = std::sqrt(norm2);
                    break;
                case 5:
                    cache[s] = (double)dot / std::sqrt(selfA * selfB);
                    break;
                case 9: {
                    double cov = (double)dot - dim * ap * aq;
                    double na = selfA - dim * ap * ap;
                    double nb = selfB - dim * aq * aq;
                    cache[s] = cov / std::sqrt(na * nb);
                    break;
                }
                case 13:
                    cache[s] = 2.0 * (double)summin / (mp + mq);
                    break;
                case 15: {
                    double cov = (double)dot - dim * ap * aq;
                    cache[s] = cov / (stddevs[a] * stddevs[b]);
                    break;
                }
                case 17: {
                    double cov = (double)dot - dim * ap * aq;
                    double na = (selfA - dim * ap * ap) / (stddevs[a] * stddevs[a]);
                    double nb = (selfB - dim * aq * aq) / (stddevs[b] * stddevs[b]);
                    double dz = cov / (stddevs[a] * stddevs[b]);
                    cache[s] = std::sqrt(na + nb - 2 * dz);
                    break;
                }
                case 18:
                    cache[s] = (double)emd;
                    break;
                case 21:
                    cache[s] = f_lengthd(v, a, b);
                    break;
                case 27: {
                    double coeff = dim * (ap + aq) / (2 * ap * aq);
                    cache[s] = coeff * (double)summin;
                    break;
                }
                case 28:
                    cache[s] = (double)dot / ((double)dot + std::sqrt(norm2));
                    break;
                case 7:
                    cache[s] = jd;
                    break;
                case 29:
                    cache[s] = js;
                    break;
            }
        }
        decide(m, cache, &out_prob[pi], &out_dist[pi]);
    };

    if constexpr (std::is_same<T, uint8_t>::value) {
#if defined(MC2_FUSED512)
        if (plan.need_emd && b_stride == 0 && !plan.need_logs) {
            // candidates-vs-one-center shape: share the center's load and
            // widening across four interleaved chains
            const uint8_t* qrow = v.row(b_rows[0]);
#pragma omp parallel for schedule(dynamic, 16)
            for (int64_t c = 0; c < (n_pairs + 3) / 4; c++) {
                int64_t pi = 4 * c;
                int64_t left = n_pairs - pi;
                if (left >= 4) {
                    const uint8_t* ps[4] = {
                        v.row(a_rows[pi]), v.row(a_rows[pi + 1]),
                        v.row(a_rows[pi + 2]), v.row(a_rows[pi + 3])};
                    uint64_t s4[4], d4[4], e4[4];
                    fused_u8_avx512_bcast_x4(ps, qrow, dim, s4, d4, e4);
                    for (int t = 0; t < 4; t++)
                        fused_one(pi + t, s4[t], d4[t], e4[t], 2);
                } else if (left >= 2) {
                    uint64_t s0, d0, e0, s1, d1, e1;
                    fused_u8_avx512_x2(v.row(a_rows[pi]), qrow,
                                       v.row(a_rows[pi + 1]), qrow, dim, &s0,
                                       &d0, &e0, &s1, &d1, &e1);
                    fused_one(pi, s0, d0, e0, 2);
                    fused_one(pi + 1, s1, d1, e1, 2);
                    if (left == 3) {
                        uint64_t s2, d2, e2;
                        fused_u8_avx512(v.row(a_rows[pi + 2]), qrow, dim, &s2,
                                        &d2, &e2);
                        fused_one(pi + 2, s2, d2, e2, 2);
                    }
                } else {
                    uint64_t s0, d0, e0;
                    fused_u8_avx512(v.row(a_rows[pi]), qrow, dim, &s0, &d0,
                                    &e0);
                    fused_one(pi, s0, d0, e0, 2);
                }
            }
        } else
#endif
        if (plan.need_emd) {
            // the EMD prefix scan is latency-bound on its serial base
            // update; interleaving two pairs' chains per step hides it
#pragma omp parallel for schedule(dynamic, 32)
            for (int64_t c = 0; c < (n_pairs + 1) / 2; c++) {
                int64_t pi = 2 * c;
                if (pi + 1 < n_pairs) {
#if defined(MC2_FUSED512)
                    uint64_t s0, d0, e0, s1, d1, e1;
                    fused_u8_avx512_x2(
                        v.row(a_rows[pi]), v.row(b_rows[pi * b_stride]),
                        v.row(a_rows[pi + 1]),
                        v.row(b_rows[(pi + 1) * b_stride]), dim, &s0, &d0,
                        &e0, &s1, &d1, &e1);
                    fused_one(pi, s0, d0, e0, 2);
                    fused_one(pi + 1, s1, d1, e1, 2);
#else
                    uint64_t e0, e1;
                    emd_u8_x2(v.row(a_rows[pi]), v.row(b_rows[pi * b_stride]),
                              v.row(a_rows[pi + 1]),
                              v.row(b_rows[(pi + 1) * b_stride]), dim, &e0,
                              &e1);
                    fused_one(pi, 0, 0, e0, 1);
                    fused_one(pi + 1, 0, 0, e1, 1);
#endif
                } else {
#if defined(MC2_FUSED512)
                    uint64_t s0, d0, e0;
                    fused_u8_avx512(v.row(a_rows[pi]),
                                    v.row(b_rows[pi * b_stride]), dim, &s0,
                                    &d0, &e0);
                    fused_one(pi, s0, d0, e0, 2);
#else
                    uint64_t e0 = emd_u8(v.row(a_rows[pi]),
                                         v.row(b_rows[pi * b_stride]), dim);
                    fused_one(pi, 0, 0, e0, 1);
#endif
                }
            }
        } else {
#pragma omp parallel for schedule(dynamic, 64)
            for (int64_t pi = 0; pi < n_pairs; pi++)
                fused_one(pi, 0, 0, 0, 0);
        }
    } else {
#pragma omp parallel for schedule(dynamic, 64)
        for (int64_t pi = 0; pi < n_pairs; pi++) fused_one(pi, 0, 0, 0, 0);
    }

    // exact recompute of borderline decisions: probability within 1e-6 of a
    // rounding threshold, or dist within a relative band of the block max
    // (the engine argmaxes dist with reference tie semantics).
    double dmax = -1e300;
    for (int64_t pi = 0; pi < n_pairs; pi++)
        if (out_dist[pi] > dmax) dmax = out_dist[pi];
    double band = 1e-9 * std::max(std::fabs(dmax), 1.0) + 1e-12;
#pragma omp parallel for schedule(dynamic, 64)
    for (int64_t pi = 0; pi < n_pairs; pi++) {
        double frac = out_prob[pi] - std::floor(out_prob[pi]);
        bool borderline = std::fabs(frac - 0.5) < 1e-6;
        borderline |= out_dist[pi] >= dmax - band;
        if (borderline)
            exact_pair(v, m, plan.fns, a_rows[pi], b_rows[pi * b_stride],
                       &out_prob[pi], &out_dist[pi]);
    }
}

}  // namespace mc2
