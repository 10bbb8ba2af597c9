// Two-track Viterbi scan for the Red HMM.
//
// At position i only the state pair (score[i], score[i]+P) is reachable
// (HMM.h:58-66), so the full Viterbi (HMM.cpp:453-574) reduces to a
// two-value recurrence per position with four gathered transitions.
// Tie-breaking matches the reference: transition ties take the negative
// track (the else branch), the final state takes the positive track on a
// tie (the first strict max over ascending state indices).
#include <cstdint>

extern "C" {

// seg:    int64 scores (state ids without offset) [n]
// priors: double log priors [2P]
// trans:  double log transitions [2P, 2P] row-major
// states_out: int8 [n] (0 = positive/repeat track, 1 = negative track)
void viterbi_two_track(const int64_t* seg, int64_t n, const double* priors,
                       const double* trans, int64_t P, int8_t* back,
                       int8_t* states_out) {
    if (n <= 0) return;
    const int64_t S = 2 * P;
    double vp = priors[seg[0]];
    double vn = priors[seg[0] + P];
    for (int64_t i = 1; i < n; i++) {
        int64_t pp = seg[i - 1], pn = seg[i - 1] + P;
        int64_t cp = seg[i], cn = seg[i] + P;
        double a = vp + trans[pp * S + cp];
        double b = vn + trans[pn * S + cp];
        double c = vp + trans[pp * S + cn];
        double d = vn + trans[pn * S + cn];
        double vp_new, vn_new;
        if (a > b) { vp_new = a; back[2 * i] = 0; }
        else       { vp_new = b; back[2 * i] = 1; }
        if (c > d) { vn_new = c; back[2 * i + 1] = 0; }
        else       { vn_new = d; back[2 * i + 1] = 1; }
        vp = vp_new;
        vn = vn_new;
    }
    int8_t cur = (vp >= vn) ? 0 : 1;
    states_out[n - 1] = cur;
    for (int64_t i = n - 1; i > 0; i--) {
        cur = back[2 * i + cur];
        states_out[i - 1] = cur;
    }
}

}  // extern "C"
