// Native batched k-mer histogram construction.
//
// Equivalent of Loader::fill_table over KmerHashTable's rolling base-4 hash
// (KmerHashTable.cpp:133-160, Loader.cpp:41-86): for every sequence, count
// k-mers over its valid segments into a dense 4^k histogram with +1
// pseudocounts saturated at the histogram dtype's max, plus the pseudocounted
// 1-mer table.  OpenMP-parallel over sequences.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <omp.h>

extern "C" {

// --threads support (CRunner.cpp:407-422 calls omp_set_num_threads): caps
// every OpenMP region in this library.
void mc2_set_num_threads(int32_t n) {
    if (n > 0) omp_set_num_threads(n);
}

// codes: concatenated int8 code arrays (0..3 valid, negative elsewhere),
//        sequence i occupying [code_offsets[i], code_offsets[i+1]).
// segs:  concatenated (start, end) inclusive pairs per sequence,
//        sequence i owning segs[2*seg_offsets[i] .. 2*seg_offsets[i+1]).
// out_counts: [n_seqs, 4^k] at elem_width (1, 2 or 4 bytes — the histogram
//             datatype's natural width, so uint8_t runs stream 4x fewer
//             bytes through every downstream gather/scan);
// out_onemers: uint64 [n_seqs, 4].
void count_kmers_batch(
    const int8_t* codes, const int64_t* code_offsets,
    const int64_t* segs, const int64_t* seg_offsets,
    int64_t n_seqs, int32_t k, uint64_t dtype_max, int32_t elem_width,
    void* out_counts, uint64_t* out_onemers) {
    const int64_t dim = (int64_t)1 << (2 * k);
    const uint64_t cap = std::min<uint64_t>(dtype_max, 0xFFFFFFFFull);
#pragma omp parallel
    {
        // per-thread uint32 scratch accumulator (written back at elem_width)
        uint32_t* scratch = (elem_width == 4) ? nullptr : new uint32_t[dim];
#pragma omp for schedule(dynamic, 8)
        for (int64_t s = 0; s < n_seqs; s++) {
            const int8_t* seq = codes + code_offsets[s];
            uint32_t* hist = (elem_width == 4)
                ? (uint32_t*)out_counts + s * dim : scratch;
            uint64_t* ones = out_onemers + s * 4;
            // raw counts first
            std::memset(hist, 0, dim * sizeof(uint32_t));
            uint64_t one_raw[4] = {0, 0, 0, 0};
            for (int64_t g = seg_offsets[s]; g < seg_offsets[s + 1]; g++) {
                int64_t start = segs[2 * g];
                int64_t end = segs[2 * g + 1];
                // 1-mers over the whole segment
                for (int64_t i = start; i <= end; i++) one_raw[seq[i]]++;
                if (end - start + 1 < k) continue;
                // rolling base-4 hash, big-endian digits
                uint64_t h = 0;
                const uint64_t mask = dim - 1;
                for (int64_t i = start; i < start + k; i++) h = (h << 2) | (uint64_t)seq[i];
                hist[h]++;
                for (int64_t i = start + k; i <= end; i++) {
                    h = ((h << 2) & mask) | (uint64_t)seq[i];
                    hist[h]++;
                }
            }
            // +1 pseudocount with saturation (KmerHashTable.cpp:235-256)
            if (elem_width == 1) {
                uint8_t* out = (uint8_t*)out_counts + s * dim;
                for (int64_t i = 0; i < dim; i++)
                    out[i] = (uint8_t)std::min<uint64_t>((uint64_t)hist[i] + 1, cap);
            } else if (elem_width == 2) {
                uint16_t* out = (uint16_t*)out_counts + s * dim;
                for (int64_t i = 0; i < dim; i++)
                    out[i] = (uint16_t)std::min<uint64_t>((uint64_t)hist[i] + 1, cap);
            } else {
                for (int64_t i = 0; i < dim; i++)
                    hist[i] = (uint32_t)std::min<uint64_t>((uint64_t)hist[i] + 1, cap);
            }
            for (int32_t i = 0; i < 4; i++) ones[i] = one_raw[i] + 1;
        }
        delete[] scratch;
    }
}

// max over all sequences of (1 + max k-mer count), for dtype selection
// (CRunner.cpp:57-94)
uint64_t largest_pseudocount_batch(
    const int8_t* codes, const int64_t* code_offsets,
    const int64_t* segs, const int64_t* seg_offsets,
    int64_t n_seqs, int32_t k) {
    const int64_t dim = (int64_t)1 << (2 * k);
    uint64_t global_best = 0;
#pragma omp parallel
    {
        uint32_t* hist = new uint32_t[dim];
        uint64_t best = 0;
#pragma omp for schedule(dynamic, 8) nowait
        for (int64_t s = 0; s < n_seqs; s++) {
            const int8_t* seq = codes + code_offsets[s];
            std::memset(hist, 0, dim * sizeof(uint32_t));
            for (int64_t g = seg_offsets[s]; g < seg_offsets[s + 1]; g++) {
                int64_t start = segs[2 * g];
                int64_t end = segs[2 * g + 1];
                if (end - start + 1 < k) continue;
                uint64_t h = 0;
                const uint64_t mask = dim - 1;
                for (int64_t i = start; i < start + k; i++) h = (h << 2) | (uint64_t)seq[i];
                hist[h]++;
                for (int64_t i = start + k; i <= end; i++) {
                    h = ((h << 2) & mask) | (uint64_t)seq[i];
                    hist[h]++;
                }
            }
            for (int64_t i = 0; i < dim; i++)
                if (hist[i] > best) best = hist[i];
        }
#pragma omp critical
        if (best + 1 > global_best) global_best = best + 1;
        delete[] hist;
    }
    return global_best;
}

// Raw (un-pseudocounted) word counts over one record's valid segments,
// accumulated into a shared [4^k] int64 table (TableBuilder.cpp:59-104's
// KmerHashTable::wholesaleIncrement path).
void count_words_raw(
    const int8_t* codes, const int64_t* segs, int64_t n_segs,
    int32_t k, int64_t* out_counts) {
    const uint64_t mask = (((uint64_t)1) << (2 * k)) - 1;
    for (int64_t g = 0; g < n_segs; g++) {
        const int64_t start = segs[2 * g];
        const int64_t end = segs[2 * g + 1];
        if (end - start + 1 < k) continue;
        uint64_t h = 0;
        for (int64_t i = start; i < start + k; i++) h = (h << 2) | (uint64_t)codes[i];
        out_counts[h]++;
        for (int64_t i = start + k; i <= end; i++) {
            h = ((h << 2) & mask) | (uint64_t)codes[i];
            out_counts[h]++;
        }
    }
}

// Red stage 4 prologue: per-base adjusted scores for one record — rolling
// k-mer hash over each segment gathered through the score table, with the
// reference's tail fill (positions e-k+2..e copy the last scored value,
// Scorer.cpp:20-47).  out_scores must be zero-initialized (segments
// shorter than k stay zero).
void red_score_bases(
    const int8_t* codes, const int64_t* segs, int64_t n_segs,
    int32_t k, const int64_t* table, int64_t* out_scores) {
    const uint64_t mask = (((uint64_t)1) << (2 * k)) - 1;
    for (int64_t g = 0; g < n_segs; g++) {
        const int64_t start = segs[2 * g];
        const int64_t end = segs[2 * g + 1];
        const int64_t m = end - start + 2 - k;
        if (m <= 0) continue;
        uint64_t h = 0;
        for (int64_t i = start; i < start + k; i++) h = (h << 2) | (uint64_t)codes[i];
        out_scores[start] = table[h];
        for (int64_t i = 1; i < m; i++) {
            h = ((h << 2) & mask) | (uint64_t)codes[start + k - 1 + i];
            out_scores[start + i] = table[h];
        }
        const int64_t last = out_scores[start + m - 1];
        for (int64_t i = start + m; i <= end; i++) out_scores[i] = last;
    }
}

// Red detector: boxcar first/second differences over window w
// (DetectorMaxima.cpp:205-266).  Bitwise-identical to the numpy path in
// red/detector.py:_derivatives: a sequential float64 cumsum (matching
// np.cumsum's accumulation order) then rounded window differences.
// first/second have n - 2w entries.
void red_derivatives(
    const double* scores, int64_t n, int64_t w,
    double* cumsum_buf /* [n+1] scratch */, double* first, double* second) {
    cumsum_buf[0] = 0.0;
    for (int64_t i = 0; i < n; i++) cumsum_buf[i + 1] = cumsum_buf[i] + scores[i];
    const int64_t m = n - 2 * w;
#pragma omp parallel for schedule(static)
    for (int64_t j = 0; j < m; j++) {
        const int64_t i = j + w;
        const double left = cumsum_buf[i] - cumsum_buf[i - w];
        const double right = cumsum_buf[i + w + 1] - cumsum_buf[i + 1];
        const double f = right - left;
        const double s = left + right - 2.0 * (double)w * scores[i];
        first[j] = (f < 0.0) ? __builtin_ceil(f - 0.5) : __builtin_floor(f + 0.5);
        second[j] = (s < 0.0) ? __builtin_ceil(s - 0.5) : __builtin_floor(s + 0.5);
    }
}

// Red stage 1: fused Markov expectation chain + adjusted scores
// (EnrichmentMarkovView.cpp:134-215).  For every word y of the 4^k table:
// expected = l * prod(conditionals over digit windows), score =
// round(observed - expected) when observed >= min_obs and observed >
// expected, else 0.  The multiplication order matches red/table.py's numpy
// path exactly (each *= is one IEEE rounding), so results are bitwise
// identical; the quaternary-counter quirk (words starting with digit 3 use
// y >> 2) is applied up front.
//
// probs: concatenated conditional tables for orders m = 0..order, table m
// holding 4^(m+1) doubles at prob_offsets[m].
void red_chain_scores(
    const int64_t* observed, const double* probs, const int64_t* prob_offsets,
    int32_t k, int32_t order, double l, int64_t min_obs,
    int64_t* out_scores) {
    const int64_t d = (int64_t)1 << (2 * k);
    const int64_t quirk_start = 3 * (d / 4);
    const int64_t rs = k - order - 1;
#pragma omp parallel for schedule(static)
    for (int64_t y = 0; y < d; y++) {
        const int64_t w = (y >= quirk_start) ? (y >> 2) : y;
        double chain = l;
        for (int32_t m = 0; m < order; m++) {
            const int32_t len = m + 1;
            const int64_t idx = (w >> (2 * (k - len))) & (((int64_t)1 << (2 * len)) - 1);
            chain *= probs[prob_offsets[m] + idx];
        }
        const double* top = probs + prob_offsets[order];
        const int32_t len = order + 1;
        const int64_t mask = ((int64_t)1 << (2 * len)) - 1;
        for (int64_t i = 0; i < rs; i++) {
            chain *= top[(w >> (2 * (k - len - i))) & mask];
        }
        chain *= top[(w >> (2 * (k - len - rs))) & mask];
        const int64_t obs = observed[y];
        if (obs >= min_obs && (double)obs > chain) {
            out_scores[y] = (int64_t)__builtin_floor((double)obs - chain + 0.5);
        } else {
            out_scores[y] = 0;
        }
    }
}

}  // extern "C"
