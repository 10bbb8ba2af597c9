// Single-pass FASTA scanner — the native data loader's parse stage.
//
// One memchr-driven pass over the raw file buffer produces everything the
// Python fast path (io/fasta.py:_parse_fast) needs: header [start, end)
// byte ranges (CR-stripped), the concatenated sequence blob with
// newlines/CRs removed, and per-record blob offsets.  Byte-for-byte the
// records of io/fasta.py:iter_fasta on every input it accepts; inputs that
// need the per-line path (space/tab line starts, a CR not part of CRLF)
// return -1 and the caller falls back.
//
// Rationale: this environment's numpy build runs uint8 elementwise ufuncs
// at ~0.07 GB/s (no SIMD inner loops), so the vectorized-numpy parse spent
// tens of seconds per GB in mask construction alone; glibc memchr streams
// at ~GB/s.
#include <cstdint>
#include <cstring>

extern "C" {

// Returns 0 on success, -1 when the caller must use the per-line parser.
// hdr_ranges: [2 * max_hdrs] (start, end) byte ranges of header lines
//   INCLUDING the leading '>' and excluding any trailing CR.
// blob: capacity n; rec_offsets: [max_hdrs + 1].
int fasta_scan_fill(const uint8_t* data, int64_t n, int64_t max_hdrs,
                    int64_t* hdr_ranges, uint8_t* blob, int64_t* rec_offsets,
                    int64_t* out_n_records, int64_t* out_blob_len) {
    // pre-fault the (freshly allocated) blob in parallel: first-touch page
    // faults at this size dominate the serial scan otherwise
    const int64_t kChunk = 16 << 20;
#pragma omp parallel for schedule(static)
    for (int64_t off = 0; off < n; off += kChunk)
        memset(blob + off, 0, off + kChunk <= n ? kChunk : n - off);
    int64_t nrec = 0;
    int64_t blob_len = 0;
    int64_t pos = 0;
    bool seen_header = false;
    while (pos < n) {
        const uint8_t* nl = (const uint8_t*)memchr(data + pos, '\n', n - pos);
        int64_t line_end = nl ? (int64_t)(nl - data) : n;  // exclusive, at \n
        int64_t body_end = line_end;                       // minus trailing CR
        // CR policy: a CR is only legal immediately before the newline
        const uint8_t* cr =
            (const uint8_t*)memchr(data + pos, '\r', line_end - pos);
        if (cr) {
            if ((int64_t)(cr - data) != line_end - 1 || !nl) return -1;
            body_end = line_end - 1;
        }
        uint8_t first = pos < n && pos < body_end ? data[pos] : 0;
        if (first == ' ' || first == '\t') return -1;
        if (first == '>') {
            if (nrec >= max_hdrs) return -1;  // caller sized via count('>')
            if (seen_header) rec_offsets[nrec] = blob_len;
            hdr_ranges[2 * nrec] = pos;
            hdr_ranges[2 * nrec + 1] = body_end;
            nrec++;
            seen_header = true;
        } else if (seen_header && body_end > pos) {
            memcpy(blob + blob_len, data + pos, body_end - pos);
            blob_len += body_end - pos;
        }
        pos = line_end + 1;
    }
    // rec_offsets[i] (start of record i's blob bytes) was written when
    // header i was found, for i >= 1; close the standard offsets form.
    // rec_offsets[0] is written unconditionally: with '>' bytes mid-line but
    // no header line, nrec == 0 and the caller still reads rec_offsets[:1].
    rec_offsets[0] = 0;
    rec_offsets[nrec] = blob_len;
    *out_n_records = nrec;
    *out_blob_len = blob_len;
    return 0;
}

}  // extern "C"
