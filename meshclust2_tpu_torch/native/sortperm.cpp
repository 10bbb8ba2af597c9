// Native sort-permutation helpers.
//
// The reference orders points with std::sort (unstable introsort) on
// length/header/|val-id| keys (CRunner.cpp:538-539, bvec.cpp:215-233,
// Predictor.cpp:655-656); tie order between equal keys is therefore
// libstdc++'s positional introsort behavior, which is observable in cluster
// output.  Sorting an index vector with a key comparator performs the exact
// same swap sequence as sorting the element vector, so these helpers
// reproduce the reference permutations bit-for-bit while giving the Python
// engine O(n log n) native sorting.
//
// Built as a shared library, bound via ctypes (no pybind11 dependency).
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

void sort_perm_u64(const uint64_t* keys, int64_t n, int64_t* perm) {
    std::iota(perm, perm + n, (int64_t)0);
    std::sort(perm, perm + n,
              [keys](int64_t a, int64_t b) { return keys[a] < keys[b]; });
}

void sort_perm_f64(const double* keys, int64_t n, int64_t* perm) {
    std::iota(perm, perm + n, (int64_t)0);
    std::sort(perm, perm + n,
              [keys](int64_t a, int64_t b) { return keys[a] < keys[b]; });
}

// Lexicographic byte-string sort: strings packed in `buf` with
// offsets[i]..offsets[i+1] delimiting string i (std::string::operator<).
void sort_perm_bytes(const uint8_t* buf, const int64_t* offsets, int64_t n,
                     int64_t* perm) {
    std::iota(perm, perm + n, (int64_t)0);
    std::sort(perm, perm + n, [buf, offsets](int64_t a, int64_t b) {
        const uint8_t* pa = buf + offsets[a];
        const uint8_t* pb = buf + offsets[b];
        int64_t la = offsets[a + 1] - offsets[a];
        int64_t lb = offsets[b + 1] - offsets[b];
        int c = std::memcmp(pa, pb, (size_t)std::min(la, lb));
        if (c != 0) return c < 0;
        return la < lb;
    });
}

}  // extern "C"
