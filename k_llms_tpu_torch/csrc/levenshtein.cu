// Exact Levenshtein distances of a batch of code pairs for Hopper (sm_90a),
// written by hand.
//
// The JAX package computes these in one jitted lax.scan
// (k_llms_tpu/consensus/device.py, _lev_kernel): P pairs of int32 codes
// [P, L], zero-padded, with their lengths, scanned column by column of b with
// the DP row of every pair as the carry. This kernel gives the same integers:
//   a, b [P, L] int32 byte codes (0..255: the encoder's ASCII), alen, blen
//   [P] int32 (0 <= len <= L <= 128),
//   out [P] int32 = levenshtein(a[p, :alen[p]], b[p, :blen[p]]).
// One thread per pair. Its DP row D[0..alen][j] lives in shared memory as
// 16-bit values (a distance is at most 128), interleaved across the block's
// threads so a warp's row reads fall in distinct banks; its a codes sit in
// shared memory as bytes. For each column j < blen the row is rewritten in
// place, the insertion chain D[i-1][j+1] + 1 carried as a running value, and
// the result is read at row position alen once the column loop ends at blen
// (row[alen] = alen when blen = 0). Loops stop at each pair's own lengths,
// so a pair costs alen * blen cells.
//
// What bounds it on this card: integer operations and latency. Each cell is
// a handful of dependent integer operations (compare, adds, two minimums),
// serial within a thread; with one thread per pair a launch of 64 pairs runs
// on one SM. A bit-parallel (Myers) redesign over 64-bit words is the next
// step. The plain version is ops/levenshtein.py::levenshtein_plain.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kMaxLen = 128;

__global__ void __launch_bounds__(kThreads)
levenshtein_kernel(const int* __restrict__ a, const int* __restrict__ alen_p,
                   const int* __restrict__ b, const int* __restrict__ blen_p,
                   int* __restrict__ out, int P, int L) {
  __shared__ uint16_t row_s[(kMaxLen + 1) * kThreads];
  __shared__ uint8_t a_s[kMaxLen * kThreads];
  const int t = threadIdx.x;
  const int p = blockIdx.x * kThreads + t;
  if (p >= P) return;
  const int alen = min(max(alen_p[p], 0), L);
  const int blen = min(max(blen_p[p], 0), L);
  uint16_t* row = row_s + t;  // row position i at row[i * kThreads]
  uint8_t* as = a_s + t;
  const int* ap = a + (size_t)p * L;
  const int* bp = b + (size_t)p * L;
  for (int i = 0; i <= alen; ++i) row[i * kThreads] = (uint16_t)i;
  for (int i = 0; i < alen; ++i) as[i * kThreads] = (uint8_t)ap[i];
  for (int j = 0; j < blen; ++j) {
    const int bj = bp[j];
    int diag = row[0];  // D[0][j]
    int left = j + 1;   // D[0][j+1]
    row[0] = (uint16_t)left;
    for (int i = 1; i <= alen; ++i) {
      const int up = row[i * kThreads];  // D[i][j]
      int v = min(diag + (as[(i - 1) * kThreads] != bj ? 1 : 0), up + 1);
      v = min(v, left + 1);  // insertion chain
      row[i * kThreads] = (uint16_t)v;
      diag = up;
      left = v;
    }
  }
  out[p] = row[alen * kThreads];  // result column
}

}  // namespace

extern "C" int kllms_levenshtein(const void* a, const void* alen, const void* b,
                                 const void* blen, void* out, int P, int L, void* stream) {
  if (P <= 0 || L <= 0 || L > kMaxLen) return (int)cudaErrorInvalidValue;
  const dim3 grid((P + kThreads - 1) / kThreads);
  levenshtein_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)a, (const int*)alen, (const int*)b, (const int*)blen, (int*)out, P, L);
  return (int)cudaGetLastError();
}
