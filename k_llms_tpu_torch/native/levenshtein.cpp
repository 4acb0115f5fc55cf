// Levenshtein edit distance on UTF-32 code points.
//
// Native replacement for the python-Levenshtein C wheel used by the reference
// (k_llms/utils/consensus_utils.py:15,759). Called from Python via
// ctypes (see k_llms_tpu_torch/native/__init__.py). Classic two-row dynamic program;
// inputs in the consensus engine are alnum-normalized so typically ASCII, but we
// operate on code points for full parity with the wheel.

#include <cstdint>
#include <vector>
#include <algorithm>

extern "C" {

int64_t kllms_levenshtein(const uint32_t* a, int64_t la, const uint32_t* b, int64_t lb) {
    if (la == 0) return lb;
    if (lb == 0) return la;
    // Keep the inner row the shorter one.
    if (lb > la) {
        std::swap(a, b);
        std::swap(la, lb);
    }
    std::vector<int64_t> row(static_cast<size_t>(lb) + 1);
    for (int64_t j = 0; j <= lb; ++j) row[static_cast<size_t>(j)] = j;
    for (int64_t i = 1; i <= la; ++i) {
        int64_t prev_diag = row[0];
        row[0] = i;
        const uint32_t ca = a[i - 1];
        for (int64_t j = 1; j <= lb; ++j) {
            const int64_t prev = row[static_cast<size_t>(j)];
            const int64_t sub = prev_diag + (ca == b[j - 1] ? 0 : 1);
            const int64_t del = prev + 1;
            const int64_t ins = row[static_cast<size_t>(j - 1)] + 1;
            row[static_cast<size_t>(j)] = std::min(sub, std::min(del, ins));
            prev_diag = prev;
        }
    }
    return row[static_cast<size_t>(lb)];
}

// Batched variant: distances between one query and n candidates packed
// back-to-back (offsets[i]..offsets[i+1] delimit candidate i). Lets the consensus
// engine score a similarity row in one FFI crossing.
void kllms_levenshtein_batch(const uint32_t* q, int64_t lq,
                             const uint32_t* pool, const int64_t* offsets,
                             int64_t n, int64_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        const uint32_t* c = pool + offsets[i];
        const int64_t lc = offsets[i + 1] - offsets[i];
        out[i] = kllms_levenshtein(q, lq, c, lc);
    }
}

}  // extern "C"
