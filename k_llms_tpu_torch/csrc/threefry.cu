// Seeded uniforms of one decode step for Hopper (sm_90a), written by hand.
//
// The JAX package draws its samples with XLA's threefry ops (no Pallas
// kernel). Its coalesced engine keys row i of request j at decode step s as
// fold_in(fold_in(key(seed_j), s), i) (k_llms_tpu/engine/engine.py,
// _row_keys); its continuous loop keys row r, of its own request at its own
// step, as fold_in(fold_in(key(seed_r), step_r), index_r)
// (k_llms_tpu/engine/continuous.py, _row_keys). jax.random.categorical then
// draws uniforms jax.random.uniform(key, (V,), minval=tiny, maxval=1) from
// the row key. This kernel writes those uniforms, bit for bit, with a key,
// step and index per row (the coalesced step repeats each request's key):
//   keys [B, 2] int64 (uint32 key words), steps [B] int32, index [B] int32,
//   out [B, V] float32.
// Each thread derives its row key with two threefry calls (the step fold,
// then the index fold), then writes kCols columns strided by the block width,
// so neighbouring threads store neighbouring words. Column c's 32 bits are
// y0 ^ y1 of threefry2x32(row key, (0, c)), the partitionable counter layout
// (jax_threefry_partitionable); the float is
// max(tiny, f * (1 - tiny) + tiny) with f = bitcast((bits >> 9) | 1.0f) - 1.
// 1 - tiny rounds to 1.0f, so f * 1.0f is exact and the multiply-add rounds
// the same fused or unfused; nvcc's default flags (no --use_fast_math) keep
// the rest IEEE. The plain version is ops/random.py::threefry_uniform_rows_plain.
//
// What bounds it on this card: bytes. The output, B * V * 4 bytes, is
// written once (8 x 128,256 floats = 4.1 MB: about 1.2 us at 3.35 TB/s);
// each column costs one threefry call (20 rounds of add, rotate, xor), about
// 100 integer operations per 4-byte word, within the SMs' integer rate at
// that byte rate. Steps and indices are read from device memory, not passed
// by value, so a captured launch replays at any step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 8;  // columns per thread

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = rotl(x1, rot[g & 1][i]) ^ x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + (uint32_t)(g + 1);
  }
}

// Row r's key is fold_in(fold_in(keys[r], steps[r]), index[r]), with
// fold_in(key, d) = threefry2x32(key, (0, d)); then kCols columns per
// thread, strided by the block width.
__global__ void __launch_bounds__(kThreads)
threefry_uniform_rows_kernel(const long long* __restrict__ keys, const int* __restrict__ steps,
                             const int* __restrict__ index, float* __restrict__ out, int V) {
  const int row = blockIdx.y;
  uint32_t a = 0u, b = (uint32_t)steps[row];
  threefry2x32((uint32_t)keys[2 * row], (uint32_t)keys[2 * row + 1], a, b);
  uint32_t k0 = 0u, k1 = (uint32_t)index[row];
  threefry2x32(a, b, k0, k1);
  float* __restrict__ out_row = out + (size_t)row * V;
  const float tiny = 1.17549435e-38f;  // FLT_MIN, numpy's finfo(float32).tiny
  const float scale = 1.0f - tiny;     // rounds to 1.0f, as in JAX
  const int base = blockIdx.x * (kThreads * kCols) + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int col = base + j * kThreads;
    if (col < V) {
      uint32_t y0 = 0u, y1 = (uint32_t)col;
      threefry2x32(k0, k1, y0, y1);
      const uint32_t bits = y0 ^ y1;
      const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
      out_row[col] = fmaxf(tiny, __fmaf_rn(f, scale, tiny));
    }
  }
}

}  // namespace

extern "C" int kllms_threefry_uniform_rows(const void* keys, const void* steps, const void* index,
                                           void* out, int B, int V, void* stream) {
  if (B <= 0 || V <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((V + kThreads * kCols - 1) / (kThreads * kCols), B);
  threefry_uniform_rows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)keys, (const int*)steps, (const int*)index, (float*)out, V);
  return (int)cudaGetLastError();
}
