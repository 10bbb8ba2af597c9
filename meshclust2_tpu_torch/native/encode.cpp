// Native batched sequence encoding + segmentation.
//
// Replicates Chromosome::help + ChromosomeOneDigit::encode semantics
// (Chromosome.cpp:130-154,263-385, ChromosomeOneDigit.cpp:79-133,
// ChromosomeOneDigitDna.cpp:48-68) over a batch of raw sequence byte
// strings: uppercase, IUPAC one-digit codes, maximal non-N runs (with the
// reference's last-position quirk), <10bp gap merge + <20bp segment drop
// when the buffer exceeds 20 bases, 1Mbp splitting, effective sizes — plus
// the makeChromList doubled-buffer variant (leading space prealloc,
// Chromosome.cpp:18-25,88-97) whose effective size find_k and Red's GC
// default observe, and the literal C/G count.
#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int64_t SEG_LENGTH = 1000000;

// one-digit DNA codes; -2 invalid, 'N' handled separately.  Covers both
// cases directly — per-byte std::toupper is a locale-aware call and was
// the encoder's dominant cost.
void build_code_table(int8_t* tbl) {
    for (int i = 0; i < 256; i++) tbl[i] = -2;
    const char* letters = "ACGTRYMKSWHBVDNX";
    const int8_t codes[] = {0, 1, 2, 3, 2, 1, 0, 3, 2, 3, 1, 3, 0, 3, 1, 2};
    for (int i = 0; i < 16; i++) {
        tbl[(uint8_t)letters[i]] = codes[i];
        tbl[(uint8_t)(letters[i] + 32)] = codes[i];  // lowercase
    }
}

// byte-class tables: is-'N' (either case) and is-C/G (either case)
struct ByteTables {
    bool is_n[256] = {};
    bool is_gc[256] = {};
    ByteTables() {
        is_n[(uint8_t)'N'] = is_n[(uint8_t)'n'] = true;
        for (char c : {'C', 'G', 'c', 'g'}) is_gc[(uint8_t)c] = true;
    }
};
const ByteTables kTables;

// maximal non-N runs with the last-position quirk
// (Chromosome.cpp:263-291: a run whose start is first set at the final
// index never emits)
void raw_segments(const uint8_t* s, int64_t n, int64_t lead,
                  std::vector<int64_t>& segs) {
    // positions [0, lead) are implicitly valid (space prealloc); the letter
    // region is s[0..n-1] mapped to positions lead..lead+n-1
    const bool* is_n_tbl = kTables.is_n;
    int64_t total = lead + n;
    int64_t start = -1;
    int64_t i = 0;
    if (lead > 0 && total > 0) {
        // the lead region is one unbroken valid run from position 0
        start = 0;
        i = lead;
    }
    for (; i < total; i++) {
        bool is_n = i >= lead && is_n_tbl[s[i - lead]];
        if (!is_n && start == -1) {
            if (i == total - 1) break;  // quirk: run starting at last base
            start = i;
        } else if (is_n && start != -1) {
            segs.push_back(start);
            segs.push_back(i - 1);
            start = -1;
        } else if (i == total - 1 && !is_n && start != -1) {
            segs.push_back(start);
            segs.push_back(i);
            start = -1;
        }
    }
}

void merge_and_split(std::vector<int64_t>& segs, int64_t total) {
    if (total > 20 && segs.size() >= 2) {
        std::vector<int64_t> merged;
        int64_t s = segs[0], e = segs[1];
        for (size_t i = 2; i + 1 < segs.size(); i += 2) {
            int64_t s1 = segs[i], e1 = segs[i + 1];
            if (s1 - e < 10) {
                e = e1;
            } else {
                if (e - s + 1 >= 20) {
                    merged.push_back(s);
                    merged.push_back(e);
                }
                s = s1;
                e = e1;
            }
        }
        if (e - s + 1 >= 20) {
            merged.push_back(s);
            merged.push_back(e);
        }
        segs.swap(merged);
    }
    // 1Mbp split (Chromosome.cpp:355-385)
    std::vector<int64_t> out;
    for (size_t i = 0; i + 1 < segs.size(); i += 2) {
        int64_t s = segs[i], e = segs[i + 1];
        int64_t ln = e - s + 1;
        if (ln > SEG_LENGTH) {
            int64_t frag_num = ln / SEG_LENGTH;
            for (int64_t h = 0; h < frag_num; h++) {
                int64_t fs = s + h * SEG_LENGTH;
                int64_t fe = (h == frag_num - 1) ? e : fs + SEG_LENGTH - 1;
                out.push_back(fs);
                out.push_back(fe);
            }
        } else {
            out.push_back(s);
            out.push_back(e);
        }
    }
    segs.swap(out);
}

}  // namespace

extern "C" {

// Pass 1: per-record segment COUNTS (so Python can allocate), plus scalar
// outputs.  seqs: concatenated raw bytes; offsets[n+1].
// out_meta per record: [n_segments, effective, ref_list_effective, gc, err]
int encode_batch_meta(const uint8_t* seqs, const int64_t* offsets,
                      int64_t n_recs, int64_t* out_meta) {
#pragma omp parallel for schedule(dynamic, 16)
    for (int64_t r = 0; r < n_recs; r++) {
        const uint8_t* s = seqs + offsets[r];
        int64_t n = offsets[r + 1] - offsets[r];
        std::vector<int64_t> segs;
        raw_segments(s, n, 0, segs);
        merge_and_split(segs, n);
        int64_t eff = 0;
        for (size_t i = 0; i + 1 < segs.size(); i += 2)
            eff += segs[i + 1] - segs[i] + 1;
        // doubled-buffer variant
        std::vector<int64_t> dsegs;
        raw_segments(s, n, n, dsegs);
        merge_and_split(dsegs, 2 * n);
        int64_t ref_eff = 0;
        for (size_t i = 0; i + 1 < dsegs.size(); i += 2)
            ref_eff += dsegs[i + 1] - dsegs[i] + 1;
        int64_t gc = 0;
        for (int64_t i = 0; i < n; i++) gc += kTables.is_gc[s[i]];
        out_meta[5 * r + 0] = (int64_t)(segs.size() / 2);
        out_meta[5 * r + 1] = eff;
        out_meta[5 * r + 2] = ref_eff;
        out_meta[5 * r + 3] = gc;
        out_meta[5 * r + 4] = 0;
    }
    return 0;
}

// Pass 2: codes + segments.  seg_offsets from pass-1 counts.
// codes: int8 out, same layout as seqs; invalid letters set err in meta.
int encode_batch_fill(const uint8_t* seqs, const int64_t* offsets,
                      int64_t n_recs, int8_t* out_codes,
                      const int64_t* seg_offsets, int64_t* out_segs,
                      int64_t* err_out) {
    int8_t tbl[256];
    build_code_table(tbl);
    int err = 0;
#pragma omp parallel for schedule(dynamic, 16)
    for (int64_t r = 0; r < n_recs; r++) {
        const uint8_t* s = seqs + offsets[r];
        int8_t* codes = out_codes + offsets[r];
        int64_t n = offsets[r + 1] - offsets[r];
        std::vector<int64_t> segs;
        raw_segments(s, n, 0, segs);
        merge_and_split(segs, n);
        int64_t* segp = out_segs + 2 * seg_offsets[r];
        for (size_t i = 0; i < segs.size(); i++) segp[i] = segs[i];
        // encode every letter in ONE pass (out_codes may alias seqs — the
        // caller reuses the sequence blob as the codes buffer): N outside
        // segments -> -1, N inside -> code table (C), invalid -> error
        size_t gi = 0;
        bool rec_err = false;
        for (int64_t i = 0; i < n; i++) {
            uint8_t c = s[i];
            int8_t v = tbl[c];
            if (v == -2) {
                rec_err = true;
                v = -1;
            } else if (kTables.is_n[c]) {
                while (gi + 1 < segs.size() && segs[gi + 1] < i) gi += 2;
                bool inside =
                    gi + 1 < segs.size() && segs[gi] <= i && i <= segs[gi + 1];
                if (!inside) v = -1;
            }
            codes[i] = v;
        }
        if (rec_err) {
#pragma omp atomic write
            err = 1;
        }
    }
    *err_out = err;
    return 0;
}

}  // extern "C"
