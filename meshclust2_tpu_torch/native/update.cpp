// Full update/merge-phase driver (ClusterFactory::MS back half,
// ClusterFactory.cpp:635-655) running natively.
//
// The Python engine already batches this phase (one scoring call per
// iteration through a cross-iteration score memo), but the memo's sorted-
// array store (np.insert) and the per-iteration pair bookkeeping dominated
// its runtime (~90% of the phase at 100k sequences; the actual scoring was
// under 10%).  This driver replaces the whole phase with one native call:
// an open-addressing hash memo, the neighborhood pair construction, the
// classifier batch, per-cluster closest-to-mean with kept-set reuse, and
// the merge bookkeeping.
//
// Parity contract: statement-for-statement the engine.py update path
// (itself the reference's ClusterFactory.cpp:287-401,635-655 semantics):
//  - per iteration, every center j re-estimates from the members of
//    clusters [j-delta, j+delta] that pass j's uint64-truncated length
//    window and the classifier gate floor(prob+0.5) != 0; the replacement
//    is the kept member closest to the float64 mean (first strict min), or
//    members[0] when nothing is kept at delta == 0, or the old center
//    otherwise; all re-estimations read OLD centers (applied afterwards);
//  - merge pass: for each i ascending, candidates j in i+1..i+delta whose
//    center passes i's length window and whose (center_j, center_i) score
//    rounds to exactly 1; LAST strict-max-dist candidate wins
//    (Trainer.cpp:104's best.second > dist), i's members are absorbed into
//    j (even if j was itself absorbed earlier in the pass — the reference's
//    lazy-delete loses those members, preserved here), i lazily deleted,
//    deletions compacted after the pass;
//  - early stop when the cluster count equals the count three iterations
//    ago (ClusterFactory.cpp:636-646), then one final delta=0 pass;
//  - the score memo is exact reuse keyed by the ordered pair (a*n + b);
//    misses are scored in one batch per scorer call, in first-miss order,
//    so the fused kernel's borderline-recheck band sees the same batches
//    as the Python memo path.
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <vector>

#include "score_impl.h"

namespace {

// coarse phase accounting, printed to stderr when MC2_NATIVE_PROF is set
struct UpdateProf {
    double lookup = 0, score = 0, pairs = 0, ctm = 0, kept = 0, insert = 0,
           total = 0;
    int64_t lookups = 0, scored = 0;
    bool on = std::getenv("MC2_NATIVE_PROF") != nullptr;
    static double now() {
        return std::chrono::duration<double>(
                   std::chrono::steady_clock::now().time_since_epoch())
            .count();
    }
    void dump() const {
        if (!on) return;
        std::fprintf(stderr,
                     "[native update] memo-lookup %.3fs (%lld keys)  "
                     "score %.3fs (%lld pairs)  pair-build %.3fs  "
                     "kept-build %.3fs  memo-insert %.3fs  "
                     "closest-to-mean %.3fs  total %.3fs\n",
                     lookup, (long long)lookups, score, (long long)scored,
                     pairs, kept, insert, ctm, total);
    }
};
UpdateProf g_prof;

using mc2::ModelSpec;
using mc2::PointsView;
using mc2::ScorePlan;
using mc2::closest_to_mean;

typedef void (*mc2_progress_cb)(int64_t);
// Per-iteration state export for checkpointing: (iteration_completed,
// n_clusters, centers[n], member_offsets[n+1], members[total], total).
// A nonzero return aborts the remaining iterations (reserved; the Python
// side currently always returns 0).
typedef int (*mc2_state_cb)(int64_t, int64_t, const int64_t*,
                            const int64_t*, const int64_t*, int64_t);

// Open-addressing (prob, dist) memo keyed by a*n+b.  Keys are nonnegative;
// empty slots hold -1.  Key and values share one 24-byte slot so a probe
// (insert or hit) touches a single cache line — the split key/value array
// layout cost two misses per operation and dominated the update phase
// (~0.7s of a 1.3s phase at 100k sequences).
class ScoreMemo {
    struct Slot {
        int64_t key;
        double prob;
        double dist;
    };

  public:
    explicit ScoreMemo(size_t expect) {
        size_t cap = 1024;
        while (cap < expect * 2) cap <<= 1;
        slots_.assign(cap, Slot{-1, 0.0, 0.0});
    }

    bool lookup(int64_t key, double* prob, double* dist) const {
        size_t mask = slots_.size() - 1;
        size_t i = slot(key);
        while (slots_[i].key != -1) {
            if (slots_[i].key == key) {
                *prob = slots_[i].prob;
                *dist = slots_[i].dist;
                return true;
            }
            i = (i + 1) & mask;
        }
        return false;
    }

    void insert(int64_t key, double prob, double dist) {
        if (2 * (count_ + 1) > slots_.size()) grow();
        size_t mask = slots_.size() - 1;
        size_t i = slot(key);
        while (slots_[i].key != -1) {
            if (slots_[i].key == key) return;  // first value wins (exact dupes)
            i = (i + 1) & mask;
        }
        slots_[i] = Slot{key, prob, dist};
        count_++;
    }

    // presize before a batch of inserts so growth never rehashes mid-batch
    void reserve_extra(size_t extra) {
        size_t need = count_ + extra;
        if (2 * need <= slots_.size()) return;
        size_t cap = slots_.size();
        while (2 * need > cap) cap <<= 1;
        rehash(cap);
    }

    int64_t misses() const { return misses_; }
    void add_misses(int64_t k) { misses_ += k; }

  private:
    size_t slot(int64_t key) const {
        uint64_t h = (uint64_t)key * 0x9E3779B97F4A7C15ull;
        return (size_t)(h >> 17) & (slots_.size() - 1);
    }

    void grow() { rehash(slots_.size() * 2); }

    void rehash(size_t cap) {
        std::vector<Slot> old;
        old.swap(slots_);
        slots_.assign(cap, Slot{-1, 0.0, 0.0});
        size_t mask = cap - 1;
        for (const Slot& s : old) {
            if (s.key == -1) continue;
            size_t i = slot(s.key);
            while (slots_[i].key != -1) i = (i + 1) & mask;
            slots_[i] = s;
        }
    }

    std::vector<Slot> slots_;
    size_t count_ = 0;
    int64_t misses_ = 0;
};

struct ClusterState {
    int64_t center;
    std::vector<int64_t> members;
    bool deleted = false;
    // kept-set reuse for closest-to-mean (engine.py's _ms_kept/_ms_result)
    std::vector<int64_t> prev_kept;
    int64_t prev_result = -1;
    bool has_prev = false;
    // Fixed-point segment skipping (exact): `stable` means the last update
    // pass (same delta, window undisturbed by merges since) left this
    // center unchanged — its inputs (own center + neighborhood member
    // lists) are identical this pass, so the result is identical and every
    // pair is already in the memo; the segment can be skipped without
    // changing the miss stream.
    bool stable = false;
    bool center_changed = true;  // did the latest update pass move it?
    // did the latest merge pass disturb this cluster's ±delta window
    // (a removal shifts the window's composition; an absorber's member
    // list grows)?  Gates the next merge pass's segment skip.
    bool merge_dirty = true;
};

// Score pairs through the memo: hits are returned verbatim, misses are
// scored in ONE batch in first-appearance order (the same batching the
// Python memo performs, so the fused borderline-recheck band matches).
template <typename T>
void memo_score(const PointsView<T>& v, const ModelSpec& m,
                ScorePlan<T>& plan, ScoreMemo& memo, int64_t n_points,
                const std::vector<int64_t>& a_arr,
                const std::vector<int64_t>& b_arr, std::vector<double>* prob,
                std::vector<double>* dist) {
    int64_t np = (int64_t)a_arr.size();
    prob->resize(np);
    dist->resize(np);
    double t0 = g_prof.on ? UpdateProf::now() : 0;
    std::vector<int64_t> miss_idx;
    for (int64_t i = 0; i < np; i++) {
        int64_t key = a_arr[i] * n_points + b_arr[i];
        if (!memo.lookup(key, &(*prob)[i], &(*dist)[i])) miss_idx.push_back(i);
    }
    if (g_prof.on) {
        g_prof.lookup += UpdateProf::now() - t0;
        g_prof.lookups += np;
    }
    if (miss_idx.empty()) return;
    std::vector<int64_t> ma(miss_idx.size()), mb(miss_idx.size());
    for (size_t k = 0; k < miss_idx.size(); k++) {
        ma[k] = a_arr[miss_idx[k]];
        mb[k] = b_arr[miss_idx[k]];
    }
    std::vector<double> mp(miss_idx.size()), md(miss_idx.size());
    t0 = g_prof.on ? UpdateProf::now() : 0;
    mc2::score_pairs(v, m, plan, ma.data(), mb.data(), /*b_stride=*/1,
                     (int64_t)ma.size(), mp.data(), md.data());
    if (g_prof.on) {
        g_prof.score += UpdateProf::now() - t0;
        g_prof.scored += (int64_t)ma.size();
    }
    memo.add_misses((int64_t)ma.size());
    t0 = g_prof.on ? UpdateProf::now() : 0;
    memo.reserve_extra(miss_idx.size());
    for (size_t k = 0; k < miss_idx.size(); k++) {
        (*prob)[miss_idx[k]] = mp[k];
        (*dist)[miss_idx[k]] = md[k];
        memo.insert(ma[k] * n_points + mb[k], mp[k], md[k]);
    }
    if (g_prof.on) g_prof.insert += UpdateProf::now() - t0;
}

template <typename T>
void mean_shift_update_pass(const PointsView<T>& v, const ModelSpec& m,
                            ScorePlan<T>& plan, ScoreMemo& memo,
                            int64_t n_points, double sim, int64_t delta,
                            std::vector<ClusterState>& clusters,
                            bool allow_skip) {
    int64_t C = (int64_t)clusters.size();
    // flat (center j, neighborhood member) pair list with j's length window;
    // reserve for the segments that will actually build pairs (skipped
    // fixed-point segments contribute nothing — sizing over everything
    // would malloc ~100 MB buffers per near-converged pass at 1M members)
    std::vector<int64_t> a_arr, b_arr;
    int64_t reserve_pairs = 0;
    for (int64_t j = 0; j < C; j++) {
        if (allow_skip && clusters[j].stable) continue;
        int64_t lo = j - delta < 0 ? 0 : j - delta;
        int64_t hi = j + delta >= C ? C - 1 : j + delta;
        for (int64_t g = lo; g <= hi; g++)
            reserve_pairs += (int64_t)clusters[g].members.size();
    }
    a_arr.reserve(reserve_pairs);
    b_arr.reserve(reserve_pairs);
    double tp0 = g_prof.on ? UpdateProf::now() : 0;
    std::vector<int64_t> seg_bounds(C + 1, 0);
    std::vector<uint8_t> skipped(C, 0);
    for (int64_t j = 0; j < C; j++) {
        if (allow_skip && clusters[j].stable) {
            // fixed point: inputs identical to the previous pass (center
            // unchanged, member lists untouched since the last merge), so
            // the result is the current center and every pair is a memo hit
            skipped[j] = 1;
            seg_bounds[j + 1] = (int64_t)a_arr.size();
            continue;
        }
        int64_t cen = clusters[j].center;
        int64_t cl = v.lengths[cen];
        int64_t min_len = (int64_t)(sim * (double)cl);
        int64_t max_len = (int64_t)((double)cl / sim);
        int64_t lo = j - delta < 0 ? 0 : j - delta;
        int64_t hi = j + delta >= C ? C - 1 : j + delta;
        for (int64_t g = lo; g <= hi; g++)
            for (int64_t r : clusters[g].members) {
                int64_t len = v.lengths[r];
                if (len >= min_len && len <= max_len) {
                    a_arr.push_back(cen);
                    b_arr.push_back(r);
                }
            }
        seg_bounds[j + 1] = (int64_t)a_arr.size();
    }
    if (g_prof.on) g_prof.pairs += UpdateProf::now() - tp0;
    std::vector<double> prob, dist;
    memo_score(v, m, plan, memo, n_points, a_arr, b_arr, &prob, &dist);

    // per-cluster closest-to-mean over kept members, with kept-set reuse;
    // new centers applied only after every j is computed
    std::vector<int64_t> new_centers(C);
    std::vector<std::vector<int64_t>> kept(C);
    std::vector<int64_t> todo;
    double tk0 = g_prof.on ? UpdateProf::now() : 0;
    for (int64_t j = 0; j < C; j++) {
        ClusterState& cl = clusters[j];
        if (skipped[j]) {
            new_centers[j] = cl.center;
            continue;
        }
        std::vector<int64_t>& good = kept[j];
        for (int64_t i = seg_bounds[j]; i < seg_bounds[j + 1]; i++)
            if (std::floor(prob[i] + 0.5) != 0.0) good.push_back(b_arr[i]);
        if (good.empty()) {
            new_centers[j] = delta == 0 ? cl.members[0] : cl.center;
        } else if (cl.has_prev && cl.prev_kept == good) {
            new_centers[j] = cl.prev_result;
        } else {
            todo.push_back(j);
        }
    }
    if (g_prof.on) g_prof.kept += UpdateProf::now() - tk0;
    double tc0 = g_prof.on ? UpdateProf::now() : 0;
#pragma omp parallel
    {
        // 2 * dim: closest_to_mean_presummed's contract (mean + rounded
        // mean planes) — sized up front so the OpenMP region never
        // lazily resizes through the wrapper's guard
        std::vector<double> top_buf(2 * v.dim);
#pragma omp for schedule(dynamic, 4)
        for (int64_t t = 0; t < (int64_t)todo.size(); t++) {
            int64_t j = todo[t];
            new_centers[j] = closest_to_mean(v, kept[j], &top_buf);
        }
    }
    if (g_prof.on) g_prof.ctm += UpdateProf::now() - tc0;
    for (int64_t t = 0; t < (int64_t)todo.size(); t++) {
        int64_t j = todo[t];
        clusters[j].prev_kept.swap(kept[j]);
        clusters[j].prev_result = new_centers[j];
        clusters[j].has_prev = true;
    }
    for (int64_t j = 0; j < C; j++) {
        ClusterState& cl = clusters[j];
        cl.center_changed = new_centers[j] != cl.center;
        // skipped segments kept their center, so this also re-marks them
        cl.stable = !cl.center_changed;
        cl.center = new_centers[j];
    }
}

template <typename T>
void merge_pass(const PointsView<T>& v, const ModelSpec& m,
                ScorePlan<T>& plan, ScoreMemo& memo, int64_t n_points,
                double sim, int64_t delta,
                std::vector<ClusterState>& clusters, bool allow_skip) {
    int64_t C = (int64_t)clusters.size();
    std::vector<int64_t> a_arr, b_arr, jj;
    std::vector<int64_t> seg_bounds(C + 1, 0);
    for (int64_t i = 0; i < C; i++) {
        int64_t hi = i + delta >= C ? C - 1 : i + delta;
        if (allow_skip) {
            // merge decisions for i depend only on centers [i, i+delta]
            // (windows use center lengths; pairs are center-vs-center).
            // When the previous merge pass left that window undisturbed
            // (no removal within ±delta, so the same clusters occupy it)
            // and none of its centers moved in this iteration's update
            // pass, the decision repeats — and it was "no merge"
            // (i survived that pass).  Every pair is a memo hit, so
            // skipping preserves the miss stream exactly.
            bool unchanged =
                !clusters[i].center_changed && !clusters[i].merge_dirty;
            for (int64_t j = i + 1; unchanged && j <= hi; j++)
                unchanged =
                    !clusters[j].center_changed && !clusters[j].merge_dirty;
            if (unchanged) {
                seg_bounds[i + 1] = (int64_t)a_arr.size();
                continue;
            }
        }
        int64_t ci = clusters[i].center;
        int64_t cl = v.lengths[ci];
        int64_t min_len = (int64_t)((double)cl * sim);
        int64_t max_len = (int64_t)((double)cl / sim);
        for (int64_t j = i + 1; j <= hi; j++) {
            int64_t lj = v.lengths[clusters[j].center];
            if (lj >= min_len && lj <= max_len) {
                // order (candidate center j, center i) (Trainer.cpp:93)
                a_arr.push_back(clusters[j].center);
                b_arr.push_back(ci);
                jj.push_back(j);
            }
        }
        seg_bounds[i + 1] = (int64_t)a_arr.size();
    }
    std::vector<double> prob, dist;
    memo_score(v, m, plan, memo, n_points, a_arr, b_arr, &prob, &dist);

    std::vector<uint8_t> absorbed(C, 0);
    bool any_merge = false;
    for (int64_t i = 0; i < C; i++) {
        int64_t lo = seg_bounds[i], hi = seg_bounds[i + 1];
        // LAST strict-max-dist positive candidate wins (best.second > dist
        // keeps best only when strictly greater, Trainer.cpp:104)
        int64_t best = -1;
        double best_d = 0;
        for (int64_t k = lo; k < hi; k++) {
            if (std::floor(prob[k] + 0.5) != 1.0) continue;
            if (best < 0 || !(best_d > dist[k])) {
                best = k;
                best_d = dist[k];
            }
        }
        if (best < 0) continue;
        int64_t ret = jj[best];
        // absorb into ret even when ret itself was already absorbed this
        // pass (the reference's lazy-delete then loses these members)
        std::vector<int64_t>& dst = clusters[ret].members;
        std::vector<int64_t>& src = clusters[i].members;
        dst.insert(dst.end(), src.begin(), src.end());
        absorbed[ret] = 1;
        clusters[i].deleted = true;
        any_merge = true;
    }
    if (any_merge) {
        // per-segment invalidation: a removed cluster shifts the window
        // composition of everything within ±delta of it, and an absorber's
        // member list changed — survivors whose old-index ±delta window
        // contains either lose their fixed-point assumptions; everything
        // farther away keeps them (its window holds the same clusters with
        // the same members before and after compaction)
        std::vector<int32_t> pre(C + 1, 0);
        for (int64_t i = 0; i < C; i++)
            pre[i + 1] =
                pre[i] + (clusters[i].deleted || absorbed[i] ? 1 : 0);
        for (int64_t i = 0; i < C; i++) {
            if (clusters[i].deleted) continue;
            int64_t lo = i - delta < 0 ? 0 : i - delta;
            int64_t hi = i + delta >= C ? C - 1 : i + delta;
            bool dirty = pre[hi + 1] - pre[lo] > 0;
            clusters[i].merge_dirty = dirty;
            if (dirty) clusters[i].stable = false;
        }
        std::vector<ClusterState> kept;
        kept.reserve(clusters.size());
        for (ClusterState& c : clusters)
            if (!c.deleted) kept.push_back(std::move(c));
        clusters.swap(kept);
    } else {
        for (ClusterState& c : clusters) c.merge_dirty = false;
    }
}

// flatten live clusters into scratch arrays and hand them to the state
// callback; returns the callback's verdict (nonzero aborts)
int export_state(const std::vector<ClusterState>& clusters, int64_t it,
                 mc2_state_cb state_cb, std::vector<int64_t>* sc_centers,
                 std::vector<int64_t>* sc_offsets,
                 std::vector<int64_t>* sc_members) {
    int64_t C = (int64_t)clusters.size();
    sc_centers->resize(C);
    sc_offsets->resize(C + 1);
    (*sc_offsets)[0] = 0;
    int64_t total = 0;
    for (int64_t i = 0; i < C; i++) total += (int64_t)clusters[i].members.size();
    sc_members->resize(total);
    int64_t pos = 0;
    for (int64_t i = 0; i < C; i++) {
        (*sc_centers)[i] = clusters[i].center;
        for (int64_t r : clusters[i].members) (*sc_members)[pos++] = r;
        (*sc_offsets)[i + 1] = pos;
    }
    return state_cb(it, C, sc_centers->data(), sc_offsets->data(),
                    sc_members->data(), total);
}

template <typename T>
int update_run_t(const PointsView<T>& v, const ModelSpec& m, int64_t n_points,
                 double sim, int64_t delta, int64_t iterations,
                 int64_t start_it, const int64_t* prior_counts,
                 int64_t n_prior, const int64_t* in_centers,
                 const int64_t* in_offsets, const int64_t* in_members,
                 int64_t n_clusters, mc2_progress_cb progress_cb,
                 mc2_state_cb state_cb, int64_t* out_centers,
                 int64_t* out_member_offsets, int64_t* out_members,
                 int64_t* out_n_clusters, int64_t* out_iterations,
                 int64_t* out_pairs) {
    ScorePlan<T> plan;
    if (!plan.build(m, v.self_dots)) return -1;
    double tt0 = g_prof.on ? UpdateProf::now() : 0;

    std::vector<ClusterState> clusters(n_clusters);
    for (int64_t i = 0; i < n_clusters; i++) {
        clusters[i].center = in_centers[i];
        clusters[i].members.assign(in_members + in_offsets[i],
                                   in_members + in_offsets[i + 1]);
    }

    // sized to one iteration's unique pairs; grow() doubles as the memo
    // accumulates across iterations (rehash cost is trivial vs scoring)
    ScoreMemo memo((size_t)in_offsets[n_clusters]);
    // cluster-count history indexed by absolute iteration: resumes carry
    // the prior iterations' counts so the 3-iterations-ago early stop sees
    // the same history as an unbroken run
    std::vector<int64_t> num_clusters(prior_counts, prior_counts + n_prior);
    std::vector<int64_t> sc_centers, sc_offsets, sc_members;
    int64_t its = 0;
    for (int64_t it = start_it; it < iterations; it++) {
        if (it >= 3 &&
            (int64_t)clusters.size() == num_clusters[it - 3])
            break;
        // segment skipping needs one full executed iteration behind it:
        // the stable/center_changed/merge_dirty flags start pessimistic,
        // so the first iteration after entry (or resume) always runs full
        bool allow_skip = it > start_it;
        mean_shift_update_pass(v, m, plan, memo, n_points, sim, delta,
                               clusters, allow_skip);
        merge_pass(v, m, plan, memo, n_points, sim, delta, clusters,
                   allow_skip);
        num_clusters.push_back((int64_t)clusters.size());
        its++;
        if (progress_cb) progress_cb(1);
        if (state_cb &&
            export_state(clusters, it + 1, state_cb, &sc_centers,
                         &sc_offsets, &sc_members) != 0)
            break;
    }
    // the final delta=0 pass is a different function of the state — never
    // skipped
    mean_shift_update_pass(v, m, plan, memo, n_points, sim, /*delta=*/0,
                           clusters, /*allow_skip=*/false);

    int64_t C = (int64_t)clusters.size();
    int64_t pos = 0;
    out_member_offsets[0] = 0;
    for (int64_t i = 0; i < C; i++) {
        out_centers[i] = clusters[i].center;
        for (int64_t r : clusters[i].members) out_members[pos++] = r;
        out_member_offsets[i + 1] = pos;
    }
    *out_n_clusters = C;
    *out_iterations = its;
    *out_pairs = memo.misses();
    if (g_prof.on) g_prof.total = UpdateProf::now() - tt0;
    g_prof.dump();
    g_prof = UpdateProf();
    return 0;
}

}  // namespace

extern "C" {

// Runs the whole update/merge phase; outputs are caller-allocated with
// capacity n_clusters (centers, member_offsets[n_clusters+1]) and total
// member count (members).  Returns 0 on success, -1 if a model feature has
// no native implementation.
int update_run(
    const void* counts, int32_t elem_width, const int64_t* mags,
    const int64_t* lengths, const double* stddevs, const double* self_dots,
    int64_t dim, int64_t n,
    const int32_t* single_ids, const double* mins, const double* maxs,
    const uint8_t* is_sim, int32_t n_singles,
    const int32_t* combo_kinds, const int32_t* combo_idx0,
    const int32_t* combo_idx1, int32_t n_combos,
    const double* weights, double bias,
    double sim, int64_t delta, int64_t iterations,
    int64_t start_it, const int64_t* prior_counts, int64_t n_prior,
    const int64_t* in_centers, const int64_t* in_offsets,
    const int64_t* in_members, int64_t n_clusters,
    mc2_progress_cb progress_cb, mc2_state_cb state_cb,
    int64_t* out_centers, int64_t* out_member_offsets, int64_t* out_members,
    int64_t* out_n_clusters, int64_t* out_iterations, int64_t* out_pairs) {
    ModelSpec m{single_ids, mins,       maxs,       is_sim,   n_singles,
                combo_kinds, combo_idx0, combo_idx1, n_combos, weights,
                bias,        /*raw_sum=*/0};
#define RUN_BODY(T)                                                          \
    {                                                                        \
        PointsView<T> v{(const T*)counts, mags, lengths, stddevs, self_dots, \
                        dim};                                                \
        return update_run_t(v, m, n, sim, delta, iterations, start_it,       \
                            prior_counts, n_prior, in_centers, in_offsets,   \
                            in_members, n_clusters, progress_cb, state_cb,   \
                            out_centers, out_member_offsets, out_members,    \
                            out_n_clusters, out_iterations, out_pairs);      \
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
