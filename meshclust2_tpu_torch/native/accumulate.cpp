// Full accumulate-phase driver (ClusterFactory::MS front half,
// ClusterFactory.cpp:552-631) running natively.
//
// The accumulate loop is inherently sequential and data-dependent (the
// candidate pool mutates after every classifier round), so the round-1
// design drove it from Python with native scoring calls.  Per-step driver
// overhead (numpy window gathers, ctypes marshalling, bvec bookkeeping) was
// ~40% of the phase at 10k sequences; this file moves the whole loop —
// bvec queries, window scans, the same-center score cache, classifier
// scoring, and closest-to-mean re-centering — into one native call.
//
// Parity contract: behavior is the cluster/bvec.py + cluster/engine.py
// accumulate path statement for statement (which in turn is the reference's
// bvec.cpp / Trainer.cpp / ClusterFactory.cpp semantics, quirks included):
//  - bin-range queries with the reference's index_of initialization quirk
//    (below-all-bounds resolves to the last bin) and the low==high break in
//    the inner binary search (bvec.cpp:76-147);
//  - window walk front-inclusive back-exclusive in bin-major order
//    (Trainer.cpp:42);
//  - candidate length re-filter with uint64-truncated bounds
//    (Trainer.cpp:39-47);
//  - first-strict-max argmax over dist, positives = floor(prob+0.5) > 0;
//  - marked-entry sweep over FULL bins front..back in slot order
//    (bvec.cpp:341-384);
//  - re-center on the member minimizing distance_d to the float64 mean
//    (ClusterFactory.cpp:337-380), first strict min wins;
//  - the same-center scan cache (exact: scores depend only on the two
//    rows; reused verbatim when every filtered candidate is stamped).
#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <vector>

#include "score_impl.h"

namespace {

using mc2::ModelSpec;
using mc2::PointsView;
using mc2::ScorePlan;

// coarse phase accounting, printed to stderr when MC2_NATIVE_PROF is set
struct AccProf {
    double range = 0, walk = 0, score = 0, cache = 0, reduce = 0, sweep = 0,
           ctm = 0;
    bool on = std::getenv("MC2_NATIVE_PROF") != nullptr;
    static double now() {
        return std::chrono::duration<double>(
                   std::chrono::steady_clock::now().time_since_epoch())
            .count();
    }
    void dump() const {
        if (!on) return;
        std::fprintf(stderr,
                     "[native accumulate] get_range %.3fs  window-walk %.3fs  "
                     "score %.3fs  cache-copy %.3fs  reduce %.3fs  "
                     "sweep %.3fs  closest-to-mean %.3fs\n",
                     range, walk, score, cache, reduce, sweep, ctm);
    }
};
AccProf g_aprof;

typedef void (*mc2_progress_cb)(int64_t);

// Length-binned pool: compacted per-bin row vectors with parallel marks
// (cluster/bvec.py's arrays, mutated in place).
struct BVecNative {
    std::vector<std::vector<int64_t>> rows;
    std::vector<std::vector<uint8_t>> marks;
    const int64_t* bounds;
    const int64_t* lengths;
    int64_t nb;

    struct Pos {
        int64_t bin;
        int64_t slot;
    };

    // searchsorted(bounds, length, side="right") over the static bounds
    void index_of(int64_t length, int64_t* low, int64_t* high) const {
        int64_t lo = 0, hi = nb;
        while (lo < hi) {
            int64_t mid = (lo + hi) / 2;
            if (bounds[mid] <= length)
                lo = mid + 1;
            else
                hi = mid;
        }
        int64_t hi_cnt = lo;
        if (hi_cnt == 0) {  // below every bound: loop matches nothing
            *low = nb - 1;
            *high = 0;
        } else if (hi_cnt >= nb) {  // at/above the last bound: last-bin rule
            *low = nb - 1;
            *high = nb - 1;
        } else {
            *low = hi_cnt - 1;
            *high = hi_cnt - 1;
        }
    }

    // bvec.cpp:51-120; front/back outputs are -1 when not found
    void inner_index_of(int64_t length, int64_t idx, bool want_front,
                        bool want_back, int64_t* out_idx, int64_t* out_front,
                        int64_t* out_back) const {
        int64_t front_out = -1, back_out = -1;
        if (idx >= nb || rows[idx].empty()) {
            if (want_front) {
                for (int64_t i = 0; i < nb; i++)
                    if (!rows[i].empty()) {
                        idx = i;
                        front_out = 0;
                        break;
                    }
            }
            if (want_back) {
                for (int64_t i = nb - 1; i >= 0; i--)
                    if (!rows[i].empty()) {
                        idx = i;
                        back_out = 0;
                        break;
                    }
            }
            *out_idx = idx;
            *out_front = front_out;
            *out_back = back_out;
            return;
        }
        const std::vector<int64_t>& b = rows[idx];
        int64_t front = 0, back = 0;
        int64_t low = 0, high = (int64_t)b.size() - 1;
        while (low <= high) {
            int64_t mid = (low + high) / 2;
            int64_t d = lengths[b[mid]];
            if (d == length) {
                front = back = mid;
                break;
            } else if (length < d) {
                high = mid;
            } else {
                low = mid + 1;
            }
            if (low == high) {
                front = low;
                back = high;
                break;
            }
        }
        if (want_front) {
            int64_t i = front;
            while (i >= 0 && lengths[b[i]] == length) {
                front = i;
                i--;
            }
            front_out = front;
        }
        if (want_back) {
            int64_t i = back;
            while (i < (int64_t)b.size() && lengths[b[i]] == length) {
                back = i;
                i++;
            }
            back_out = back;
        }
        *out_idx = idx;
        *out_front = front_out;
        *out_back = back_out;
    }

    // bvec.cpp:260-330; returns false via *back_empty semantics
    void get_range(int64_t begin_len, int64_t end_len, Pos* front, Pos* back,
                   bool* back_empty) const {
        int64_t f_bin, b_bin, tmp;
        index_of(begin_len, &f_bin, &tmp);
        index_of(end_len, &tmp, &b_bin);
        int64_t f_slot, b_slot, unused;
        inner_index_of(begin_len, f_bin, true, false, &f_bin, &f_slot, &unused);
        inner_index_of(end_len, b_bin, false, true, &b_bin, &unused, &b_slot);
        *back_empty = (b_slot < 0);
        if (f_slot < 0) {
            f_slot = 0;
            *back_empty = true;
        }
        front->bin = f_bin;
        front->slot = f_slot;
        back->bin = b_bin;
        back->slot = b_slot < 0 ? 0 : b_slot;
    }

    int64_t pop() {
        for (int64_t i = 0; i < nb; i++)
            if (!rows[i].empty()) {
                int64_t r = rows[i].front();
                rows[i].erase(rows[i].begin());
                marks[i].erase(marks[i].begin());
                return r;
            }
        return -1;
    }

    void erase(int64_t bin, int64_t slot) {
        rows[bin].erase(rows[bin].begin() + slot);
        marks[bin].erase(marks[bin].begin() + slot);
    }

    // bvec.cpp:341-384: collect+remove marked entries over FULL bins
    // front.bin..back.bin in bin-major slot order
    void remove_available(const Pos& front, const Pos& back,
                          std::vector<int64_t>* out) {
        int64_t a = front.bin;
        int64_t b = std::min(back.bin, nb - 1);
        for (int64_t i = a; i <= b; i++) {
            std::vector<int64_t>& br = rows[i];
            std::vector<uint8_t>& bm = marks[i];
            bool any = false;
            for (uint8_t mk : bm)
                if (mk) {
                    any = true;
                    break;
                }
            if (!any) continue;
            size_t w = 0;
            for (size_t j = 0; j < br.size(); j++) {
                if (bm[j]) {
                    out->push_back(br[j]);
                } else {
                    br[w] = br[j];
                    bm[w] = 0;
                    w++;
                }
            }
            br.resize(w);
            bm.resize(w);
        }
    }
};


template <typename T>
int accumulate_run_t(const PointsView<T>& v, const ModelSpec& m, int64_t n,
                     double sim, const int64_t* bin_rows,
                     const int64_t* bin_offsets, const int64_t* bounds,
                     int64_t n_bins, mc2_progress_cb progress_cb,
                     int64_t* out_centers, int64_t* out_member_offsets,
                     int64_t* out_members, int64_t* out_n_clusters,
                     int64_t* out_windows, int64_t* out_pairs) {
    ScorePlan<T> plan;
    if (!plan.build(m, v.self_dots)) return -1;

    BVecNative bv;
    bv.bounds = bounds;
    bv.lengths = v.lengths;
    bv.nb = n_bins;
    bv.rows.resize(n_bins);
    bv.marks.resize(n_bins);
    for (int64_t i = 0; i < n_bins; i++) {
        int64_t s = bin_offsets[i], e = bin_offsets[i + 1];
        bv.rows[i].assign(bin_rows + s, bin_rows + e);
        bv.marks[i].assign(e - s, 0);
    }

    // same-center scan cache (engine.py's _cache_* arrays)
    std::vector<int64_t> cache_stamp(n, 0);
    std::vector<double> cache_prob(n), cache_dist(n);
    int64_t cache_center = -1, cache_epoch = 0;

    // scratch (sized lazily; windows can approach n)
    std::vector<int64_t> cand_rows, cand_bins, cand_slots;
    std::vector<double> prob, dist;
    std::vector<double> top_buf(2 * v.dim);
    std::vector<int64_t> members;
    // running member-order row sum for closest-to-mean: re-centering happens
    // after every sweep while `members` only ever grows, so fold in just the
    // newly swept rows (identical accumulation order → bit-identical mean)
    std::vector<double> member_sum(v.dim);
    size_t summed_upto = 0;

    int64_t windows = 0, pairs = 0;
    int64_t n_clusters = 0, member_pos = 0;
    out_member_offsets[0] = 0;

    int64_t last = bv.pop();
    while (last >= 0) {
        members.clear();
        members.push_back(last);
        std::fill(member_sum.begin(), member_sum.end(), 0.0);
        summed_upto = 0;
        bool is_min = false;
        while (!is_min) {
            int64_t length = v.lengths[last];
            int64_t begin_len = (int64_t)((double)length * sim);
            int64_t end_len = (int64_t)((double)length / sim);
            BVecNative::Pos front{0, 0}, back{0, 0};
            bool back_empty;
            double t0 = g_aprof.on ? AccProf::now() : 0;
            bv.get_range(begin_len, end_len, &front, &back, &back_empty);
            if (g_aprof.on) {
                double t1 = AccProf::now();
                g_aprof.range += t1 - t0;
                t0 = t1;
            }

            int64_t best_row = -1, best_bin = -1, best_slot = -1;
            if (back_empty) {
                is_min = true;
            } else {
                // window walk, with the candidate length re-filter inlined
                // (same order: bin-major, front inclusive to back exclusive)
                cand_rows.clear();
                cand_bins.clear();
                cand_slots.clear();
                int64_t r = front.bin, c = front.slot;
                while (r < bv.nb && c >= (int64_t)bv.rows[r].size()) {
                    r++;
                    c = 0;
                }
                while (r < bv.nb &&
                       (r < back.bin || (r == back.bin && c < back.slot))) {
                    int64_t hi = (r == back.bin) ? back.slot
                                                 : (int64_t)bv.rows[r].size();
                    for (; c < hi; c++) {
                        int64_t row = bv.rows[r][c];
                        int64_t len = v.lengths[row];
                        if (len >= begin_len && len <= end_len) {
                            cand_rows.push_back(row);
                            cand_bins.push_back(r);
                            cand_slots.push_back(c);
                        }
                    }
                    r++;
                    c = 0;
                }
                int64_t nc = (int64_t)cand_rows.size();
                if (g_aprof.on) {
                    double t1 = AccProf::now();
                    g_aprof.walk += t1 - t0;
                    t0 = t1;
                }
                if (nc == 0) {
                    is_min = true;
                } else {
                    prob.resize(nc);
                    dist.resize(nc);
                    bool hit = (last == cache_center);
                    if (hit) {
                        for (int64_t i = 0; i < nc; i++)
                            if (cache_stamp[cand_rows[i]] != cache_epoch) {
                                hit = false;
                                break;
                            }
                    }
                    if (hit) {
                        for (int64_t i = 0; i < nc; i++) {
                            prob[i] = cache_prob[cand_rows[i]];
                            dist[i] = cache_dist[cand_rows[i]];
                        }
                        if (g_aprof.on) {
                            double t1 = AccProf::now();
                            g_aprof.cache += t1 - t0;
                            t0 = t1;
                        }
                    } else {
                        mc2::score_pairs(v, m, plan, cand_rows.data(), &last,
                                         /*b_stride=*/0, nc, prob.data(),
                                         dist.data());
                        pairs += nc;
                        cache_center = last;
                        cache_epoch++;
                        for (int64_t i = 0; i < nc; i++) {
                            cache_stamp[cand_rows[i]] = cache_epoch;
                            cache_prob[cand_rows[i]] = prob[i];
                            cache_dist[cand_rows[i]] = dist[i];
                        }
                        if (g_aprof.on) {
                            double t1 = AccProf::now();
                            g_aprof.score += t1 - t0;
                            t0 = t1;
                        }
                    }
                    windows++;
                    // positives = floor(prob+0.5) > 0; argmax by dist with
                    // first-strict-max tie semantics (Trainer.cpp:57)
                    bool any_pos = false;
                    int64_t best_i = 0;
                    for (int64_t i = 0; i < nc; i++) {
                        if (dist[i] > dist[best_i]) best_i = i;
                        if (std::floor(prob[i] + 0.5) > 0) {
                            any_pos = true;
                            bv.marks[cand_bins[i]][cand_slots[i]] = 1;
                        }
                    }
                    is_min = !any_pos;
                    best_row = cand_rows[best_i];
                    best_bin = cand_bins[best_i];
                    best_slot = cand_slots[best_i];
                    if (g_aprof.on) g_aprof.reduce += AccProf::now() - t0;
                }
            }

            if (is_min) {
                int64_t nxt;
                if (best_row < 0) {
                    nxt = bv.pop();
                } else {
                    bv.erase(best_bin, best_slot);
                    nxt = best_row;
                }
                out_centers[n_clusters] = last;
                for (int64_t mrow : members) out_members[member_pos++] = mrow;
                out_member_offsets[n_clusters + 1] = member_pos;
                n_clusters++;
                if (progress_cb) progress_cb((int64_t)members.size());
                last = nxt;
            } else {
                double t0 = g_aprof.on ? AccProf::now() : 0;
                bv.remove_available(front, back, &members);
                if (g_aprof.on) {
                    double t1 = AccProf::now();
                    g_aprof.sweep += t1 - t0;
                    t0 = t1;
                }
                for (; summed_upto < members.size(); summed_upto++) {
                    const T* row = v.row(members[summed_upto]);
                    for (int64_t i = 0; i < v.dim; i++) member_sum[i] += row[i];
                }
                last = mc2::closest_to_mean_presummed(
                    v, members, member_sum.data(), &top_buf,
                    /*allow_parallel=*/true);
                if (g_aprof.on) g_aprof.ctm += AccProf::now() - t0;
            }
        }
    }

    *out_n_clusters = n_clusters;
    *out_windows = windows;
    *out_pairs = pairs;
    g_aprof.dump();
    g_aprof = AccProf();
    return 0;
}

// Resumable entry: run the SAME loop from an arbitrary mid-phase state
// (open cluster `members` centered on `last`, pool = the given bins) for at
// most `max_steps` steps, where one step = one pending-mean resolution OR
// one window scan (exactly cluster/engine.py:_resolve_steps semantics —
// this is the host side of the device loop's margin-abort-resume, which at
// 1M sequences spent ~84 s in the Python per-step path).
template <typename T>
int accumulate_resume_t(
    const PointsView<T>& v, const ModelSpec& m, int64_t n, double sim,
    const int64_t* bin_rows, const int64_t* bin_offsets,
    const int64_t* bounds, int64_t n_bins,
    const int64_t* cur_members, int64_t n_cur, int64_t last,
    int32_t pending_mean, int64_t max_steps,
    int64_t* out_centers, int64_t* out_member_offsets, int64_t* out_members,
    int64_t* out_n_clusters,
    int64_t* out_cur, int64_t* out_n_cur, int64_t* out_last,
    int64_t* out_bin_rows, int64_t* out_bin_offsets,
    int64_t* out_windows, int64_t* out_pairs) {
    ScorePlan<T> plan;
    if (!plan.build(m, v.self_dots)) return -1;

    BVecNative bv;
    bv.bounds = bounds;
    bv.lengths = v.lengths;
    bv.nb = n_bins;
    bv.rows.resize(n_bins);
    bv.marks.resize(n_bins);
    for (int64_t i = 0; i < n_bins; i++) {
        int64_t s = bin_offsets[i], e = bin_offsets[i + 1];
        bv.rows[i].assign(bin_rows + s, bin_rows + e);
        bv.marks[i].assign(e - s, 0);
    }

    std::vector<int64_t> cache_stamp(n, 0);
    std::vector<double> cache_prob(n), cache_dist(n);
    int64_t cache_center = -1, cache_epoch = 0;

    std::vector<int64_t> cand_rows, cand_bins, cand_slots;
    std::vector<double> prob, dist;
    std::vector<double> top_buf(2 * v.dim);
    std::vector<int64_t> members(cur_members, cur_members + n_cur);
    std::vector<double> member_sum(v.dim, 0.0);
    size_t summed_upto = 0;

    int64_t windows = 0, pairs = 0;
    int64_t n_clusters = 0, member_pos = 0;
    out_member_offsets[0] = 0;

    auto fold_members = [&]() {
        for (; summed_upto < members.size(); summed_upto++) {
            const T* row = v.row(members[summed_upto]);
            for (int64_t i = 0; i < v.dim; i++) member_sum[i] += row[i];
        }
    };
    auto dump_state = [&](int64_t out_last_val) {
        *out_n_clusters = n_clusters;
        *out_windows = windows;
        *out_pairs = pairs;
        *out_last = out_last_val;
        *out_n_cur = (int64_t)members.size();
        for (size_t i = 0; i < members.size(); i++) out_cur[i] = members[i];
        int64_t pos = 0;
        out_bin_offsets[0] = 0;
        for (int64_t b = 0; b < n_bins; b++) {
            for (int64_t r : bv.rows[b]) out_bin_rows[pos++] = r;
            out_bin_offsets[b + 1] = pos;
        }
        return 0;
    };

    for (int64_t step = 0; step < max_steps; step++) {
        if (pending_mean) {
            // stage-2 abort: the absorb already applied; redo only the
            // closest-to-mean with exact f64 semantics
            fold_members();
            last = mc2::closest_to_mean_presummed(
                v, members, member_sum.data(), &top_buf,
                /*allow_parallel=*/true);
            pending_mean = 0;
            continue;
        }
        int64_t length = v.lengths[last];
        int64_t begin_len = (int64_t)((double)length * sim);
        int64_t end_len = (int64_t)((double)length / sim);
        BVecNative::Pos front{0, 0}, back{0, 0};
        bool back_empty;
        bv.get_range(begin_len, end_len, &front, &back, &back_empty);

        bool is_min = false;
        int64_t best_row = -1, best_bin = -1, best_slot = -1;
        if (back_empty) {
            is_min = true;
        } else {
            cand_rows.clear();
            cand_bins.clear();
            cand_slots.clear();
            int64_t r = front.bin, c = front.slot;
            while (r < bv.nb && c >= (int64_t)bv.rows[r].size()) {
                r++;
                c = 0;
            }
            while (r < bv.nb &&
                   (r < back.bin || (r == back.bin && c < back.slot))) {
                int64_t hi = (r == back.bin) ? back.slot
                                             : (int64_t)bv.rows[r].size();
                for (; c < hi; c++) {
                    int64_t row = bv.rows[r][c];
                    int64_t len = v.lengths[row];
                    if (len >= begin_len && len <= end_len) {
                        cand_rows.push_back(row);
                        cand_bins.push_back(r);
                        cand_slots.push_back(c);
                    }
                }
                r++;
                c = 0;
            }
            int64_t nc = (int64_t)cand_rows.size();
            if (nc == 0) {
                is_min = true;
            } else {
                prob.resize(nc);
                dist.resize(nc);
                bool hit = (last == cache_center);
                if (hit) {
                    for (int64_t i = 0; i < nc; i++)
                        if (cache_stamp[cand_rows[i]] != cache_epoch) {
                            hit = false;
                            break;
                        }
                }
                if (hit) {
                    for (int64_t i = 0; i < nc; i++) {
                        prob[i] = cache_prob[cand_rows[i]];
                        dist[i] = cache_dist[cand_rows[i]];
                    }
                } else {
                    mc2::score_pairs(v, m, plan, cand_rows.data(), &last,
                                     /*b_stride=*/0, nc, prob.data(),
                                     dist.data());
                    pairs += nc;
                    cache_center = last;
                    cache_epoch++;
                    for (int64_t i = 0; i < nc; i++) {
                        cache_stamp[cand_rows[i]] = cache_epoch;
                        cache_prob[cand_rows[i]] = prob[i];
                        cache_dist[cand_rows[i]] = dist[i];
                    }
                }
                windows++;
                bool any_pos = false;
                int64_t best_i = 0;
                for (int64_t i = 0; i < nc; i++) {
                    if (dist[i] > dist[best_i]) best_i = i;
                    if (std::floor(prob[i] + 0.5) > 0) {
                        any_pos = true;
                        bv.marks[cand_bins[i]][cand_slots[i]] = 1;
                    }
                }
                is_min = !any_pos;
                best_row = cand_rows[best_i];
                best_bin = cand_bins[best_i];
                best_slot = cand_slots[best_i];
            }
        }

        if (is_min) {
            out_centers[n_clusters] = last;
            for (int64_t mrow : members) out_members[member_pos++] = mrow;
            out_member_offsets[n_clusters + 1] = member_pos;
            n_clusters++;
            int64_t nxt;
            if (best_row < 0) {
                nxt = bv.pop();
            } else {
                bv.erase(best_bin, best_slot);
                nxt = best_row;
            }
            if (nxt < 0) {
                members.clear();
                return dump_state(-1);  // pool empty: clustering complete
            }
            last = nxt;
            members.clear();
            members.push_back(last);
            std::fill(member_sum.begin(), member_sum.end(), 0.0);
            summed_upto = 0;
        } else {
            bv.remove_available(front, back, &members);
            fold_members();
            last = mc2::closest_to_mean_presummed(
                v, members, member_sum.data(), &top_buf,
                /*allow_parallel=*/true);
        }
    }
    return dump_state(last);
}

}  // namespace

extern "C" {

// Runs the whole accumulate phase; outputs are caller-allocated with
// capacity n (centers, member_offsets[n+1], members).  Returns 0 on
// success, -1 if a model feature has no native implementation.
int accumulate_run(
    const void* counts, int32_t elem_width, const int64_t* mags,
    const int64_t* lengths, const double* stddevs, const double* self_dots,
    int64_t dim, int64_t n,
    const int32_t* single_ids, const double* mins, const double* maxs,
    const uint8_t* is_sim, int32_t n_singles,
    const int32_t* combo_kinds, const int32_t* combo_idx0,
    const int32_t* combo_idx1, int32_t n_combos,
    const double* weights, double bias,
    double sim,
    const int64_t* bin_rows, const int64_t* bin_offsets,
    const int64_t* bounds, int64_t n_bins,
    mc2_progress_cb progress_cb,
    int64_t* out_centers, int64_t* out_member_offsets, int64_t* out_members,
    int64_t* out_n_clusters, int64_t* out_windows, int64_t* out_pairs) {
    ModelSpec m{single_ids, mins,       maxs,    is_sim, n_singles,
                combo_kinds, combo_idx0, combo_idx1, n_combos, weights,
                bias,        /*raw_sum=*/0};
#define RUN_BODY(T)                                                          \
    {                                                                        \
        PointsView<T> v{(const T*)counts, mags, lengths, stddevs, self_dots, \
                        dim};                                                \
        return accumulate_run_t(v, m, n, sim, bin_rows, bin_offsets, bounds, \
                                n_bins, progress_cb, out_centers,            \
                                out_member_offsets, out_members,             \
                                out_n_clusters, out_windows, out_pairs);     \
    }
    switch (elem_width) {
        case 1: RUN_BODY(uint8_t);
        case 2: RUN_BODY(uint16_t);
        case 4: RUN_BODY(uint32_t);
        default: return -1;
    }
#undef RUN_BODY
}

// Resumable accumulate (engine._resolve_steps semantics, see
// accumulate_resume_t).  Outputs caller-allocated with capacity n
// (centers, member_offsets[n+1], members, cur, bin_rows,
// bin_offsets[n_bins+1]).
int accumulate_resume(
    const void* counts, int32_t elem_width, const int64_t* mags,
    const int64_t* lengths, const double* stddevs, const double* self_dots,
    int64_t dim, int64_t n,
    const int32_t* single_ids, const double* mins, const double* maxs,
    const uint8_t* is_sim, int32_t n_singles,
    const int32_t* combo_kinds, const int32_t* combo_idx0,
    const int32_t* combo_idx1, int32_t n_combos,
    const double* weights, double bias,
    double sim,
    const int64_t* bin_rows, const int64_t* bin_offsets,
    const int64_t* bounds, int64_t n_bins,
    const int64_t* cur_members, int64_t n_cur, int64_t last,
    int32_t pending_mean, int64_t max_steps,
    int64_t* out_centers, int64_t* out_member_offsets, int64_t* out_members,
    int64_t* out_n_clusters,
    int64_t* out_cur, int64_t* out_n_cur, int64_t* out_last,
    int64_t* out_bin_rows, int64_t* out_bin_offsets,
    int64_t* out_windows, int64_t* out_pairs) {
    ModelSpec m{single_ids, mins,       maxs,    is_sim, n_singles,
                combo_kinds, combo_idx0, combo_idx1, n_combos, weights,
                bias,        /*raw_sum=*/0};
#define RUN_BODY(T)                                                          \
    {                                                                        \
        PointsView<T> v{(const T*)counts, mags, lengths, stddevs, self_dots, \
                        dim};                                                \
        return accumulate_resume_t(                                          \
            v, m, n, sim, bin_rows, bin_offsets, bounds, n_bins,             \
            cur_members, n_cur, last, pending_mean, max_steps, out_centers,  \
            out_member_offsets, out_members, out_n_clusters, out_cur,        \
            out_n_cur, out_last, out_bin_rows, out_bin_offsets, out_windows, \
            out_pairs);                                                      \
    }
    switch (elem_width) {
        case 1: RUN_BODY(uint8_t);
        case 2: RUN_BODY(uint16_t);
        case 4: RUN_BODY(uint32_t);
        default: return -1;
    }
#undef RUN_BODY
}

}  // extern "C"
