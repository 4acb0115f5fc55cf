// w4a16 matmul for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel k_llms_tpu/ops/w4matmul.py::_w4_kernel
// (entry w4_matmul). Same contract:
//   x [rows, K] (bf16 or f32), q int8 [K/2, N], scale f32 [K/128, N];
//   out [rows, N] in x's dtype,
//   out = sum_g (x[:, g] . unpack(q)[g]) * scale[g],
// where group g is 128 contraction rows: packed byte row g*64 + i holds row
// g*128 + i in its low nibble and row g*128 + 64 + i in its high nibble,
// both signed 4-bit. Each group's dot is taken in f32 over the exact small
// integers, then scaled by that group's per-column scale and accumulated in
// f32; the output is rounded to x's dtype once.
//
// Device memory never holds a dequantized weight: nibbles are unpacked in
// registers (small row counts) or into shared memory (large row counts). A
// nibble becomes a float without an int-to-float conversion: OR-ing
// (nibble ^ 8) into the mantissa of 2^23 and subtracting 2^23 + 8.
//
// What bounds it on this card: bytes at decode rows, operations at prefill
// rows. At 1-8 rows every packed weight byte feeds 2-16 FMAs, far below the
// card's balance point, so the 4-bit weights are the traffic (half of int8,
// a quarter of bf16). At prefill rows (64-2048) the product is compute
// bound, and this first version runs it on the CUDA cores in f32 (67 TFLOP/s
// at most) rather than on the tensor cores: moving the unpacked nibbles to
// bf16 `mma.sync`/`wgmma` operands is the redesign's work.
//
// Two kernels, chosen by the wrapper from the row count:
//   * w4_gemv (rows <= 64): one warp walks one 128-row group at a time for a
//     256-column tile (8 columns per lane, one 8-byte load per packed row),
//     with up to 8 rows in registers; the CTA's 4 warps take different
//     groups and add their sums in shared memory. Long contractions with
//     few column tiles are split over CTAs (`ksplit`), whose f32 partials a
//     second small kernel adds in a fixed order, so the card is filled even
//     at N = 1024.
//   * w4_gemm (rows > 64): a 64-row x 128-column tile per CTA, one group per
//     step: the x tile is widened to f32 in shared memory (k-major), the
//     group's 8 KB of packed bytes are unpacked once into a [128, 128] f32
//     tile, and each of 256 threads accumulates a 4 x 8 register tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 128;
constexpr int kHalf = kGroup / 2;

// --- small helpers ---------------------------------------------------------

__device__ __forceinline__ float nibble_lo(uint32_t word, int byte) {
  const uint32_t u = ((word >> (8 * byte)) & 0xFu) ^ 0x8u;
  return __uint_as_float(0x4B000000u | u) - 8388616.0f;
}

__device__ __forceinline__ float nibble_hi(uint32_t word, int byte) {
  const uint32_t u = ((word >> (8 * byte + 4)) & 0xFu) ^ 0x8u;
  return __uint_as_float(0x4B000000u | u) - 8388616.0f;
}

// Four consecutive x values as f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// --- few rows: GEMV-like ------------------------------------------------------

constexpr int kGemvWarps = 4;
constexpr int kGemvThreads = kGemvWarps * 32;
constexpr int kGemvCols = 256;  // 32 lanes x 8 columns
constexpr int kGemvMaxRows = 8;

// grid (ceil(N / 256), ksplit, ceil(rows / RT)). CTA (ct, ks, rc) sums the
// groups [ks * G / ksplit, (ks + 1) * G / ksplit) for rows rc*RT .. +RT and
// columns ct*256 .. +256; warp w takes every 4th of those groups and keeps
// its running sums in its own slice of shared memory. With ksplit == 1 the
// CTA writes `out`; otherwise its f32 sums go to partial[ks][row][col] for
// w4_reduce.
template <typename T, int RT>
__global__ void __launch_bounds__(kGemvThreads)
w4_gemv(const T* __restrict__ x, const uint8_t* __restrict__ q,
        const float* __restrict__ scale, T* __restrict__ out,
        float* __restrict__ partial, int rows, int K, int N, int ksplit) {
  __shared__ float acc[kGemvWarps][RT][kGemvCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * kGemvCols + lane * 8;
  const bool col_ok = col0 < N;  // N % 8 == 0: a lane's 8 columns are all in or out
  const int row0 = blockIdx.z * RT;
  const int groups = K / kGroup;
  const int per_split = groups / ksplit;
  const int g_begin = blockIdx.y * per_split;
  const int g_end = g_begin + per_split;

#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[warp][r][lane * 8 + c] = 0.0f;

  if (col_ok) {
    for (int g = g_begin + warp; g < g_end; g += kGemvWarps) {
      float part[RT][8];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) part[r][c] = 0.0f;
      const uint8_t* qg = q + (size_t)g * kHalf * N + col0;
      for (int pk = 0; pk < kHalf; pk += 4) {
        uint2 w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          w[u] = __ldg(reinterpret_cast<const uint2*>(qg + (size_t)(pk + u) * N));
        // x[row, g*128 + pk .. +4] (low-nibble rows) and the same 64 rows
        // further (high-nibble rows); rows past the end read as zeros.
        float4 xl[RT], xh[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          xl[r] = make_float4(0.f, 0.f, 0.f, 0.f);
          xh[r] = xl[r];
          if (row0 + r < rows) {
            const T* xr = x + (size_t)(row0 + r) * K + (size_t)g * kGroup + pk;
            xl[r] = load4(xr);
            xh[r] = load4(xr + kHalf);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float lo[8], hi[8];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            lo[c] = nibble_lo(w[u].x, c);
            hi[c] = nibble_hi(w[u].x, c);
            lo[c + 4] = nibble_lo(w[u].y, c);
            hi[c + 4] = nibble_hi(w[u].y, c);
          }
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            const float a = u == 0 ? xl[r].x : u == 1 ? xl[r].y : u == 2 ? xl[r].z : xl[r].w;
            const float b = u == 0 ? xh[r].x : u == 1 ? xh[r].y : u == 2 ? xh[r].z : xh[r].w;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              part[r][c] = fmaf(a, lo[c], part[r][c]);
              part[r][c] = fmaf(b, hi[c], part[r][c]);
            }
          }
        }
      }
      const float4 s0 = __ldg(reinterpret_cast<const float4*>(scale + (size_t)g * N + col0));
      const float4 s1 = __ldg(reinterpret_cast<const float4*>(scale + (size_t)g * N + col0 + 4));
      const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          acc[warp][r][lane * 8 + c] = fmaf(part[r][c], s[c], acc[warp][r][lane * 8 + c]);
    }
  }
  __syncthreads();

  // Add the warps' sums in a fixed order.
  for (int idx = threadIdx.x; idx < RT * kGemvCols; idx += kGemvThreads) {
    const int r = idx / kGemvCols;
    const int c = idx % kGemvCols;
    const int row = row0 + r;
    const int col = blockIdx.x * kGemvCols + c;
    if (row >= rows || col >= N) continue;
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < kGemvWarps; ++w) v += acc[w][r][c];
    if (ksplit == 1) {
      store_out(out + (size_t)row * N + col, v);
    } else {
      partial[((size_t)blockIdx.y * rows + row) * N + col] = v;
    }
  }
}

// out[row, col] = sum over s of partial[s, row, col], in order.
template <typename T>
__global__ void w4_reduce(const float* __restrict__ partial, T* __restrict__ out,
                          int rows, int N, int ksplit) {
  const size_t total = (size_t)rows * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = 0.0f;
    for (int s = 0; s < ksplit; ++s) v += partial[(size_t)s * total + i];
    store_out(out + i, v);
  }
}

// --- many rows: tiled ------------------------------------------------------

constexpr int kBM = 64;
constexpr int kBN = 128;
constexpr int kGemmThreads = 256;
constexpr int kXStride = kBM + 4;  // xs is k-major: [kGroup][kBM + 4]
constexpr size_t kGemmSmem = (size_t)(kGroup * kXStride + kGroup * kBN) * sizeof(float);

// grid (N / 128, ceil(rows / 64)). Thread (ty, tx) = (tid / 16, tid % 16)
// owns rows ty*4 .. +4 and columns tx*4 .. +4 and 64 + tx*4 .. +4.
template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
w4_gemm(const T* __restrict__ x, const uint8_t* __restrict__ q,
        const float* __restrict__ scale, T* __restrict__ out, int rows, int K, int N) {
  extern __shared__ float smem[];
  float* xs = smem;                      // [kGroup][kXStride]
  float* ws = smem + kGroup * kXStride;  // [kGroup][kBN]
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int row0 = blockIdx.y * kBM;
  const int colt = blockIdx.x * kBN;
  const int groups = K / kGroup;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int g = 0; g < groups; ++g) {
    // x tile -> xs[k][row] (f32). Consecutive threads take consecutive rows
    // of one 4-wide k chunk, so the transposed stores hit distinct banks.
    for (int c = tid; c < kBM * (kGroup / 4); c += kGemmThreads) {
      const int r = c % kBM;
      const int kc = (c / kBM) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < rows) v = load4(x + (size_t)(row0 + r) * K + (size_t)g * kGroup + kc);
      xs[(kc + 0) * kXStride + r] = v.x;
      xs[(kc + 1) * kXStride + r] = v.y;
      xs[(kc + 2) * kXStride + r] = v.z;
      xs[(kc + 3) * kXStride + r] = v.w;
    }
    // Packed bytes [64, 128] -> ws[k][col] (f32): 16 bytes per load.
    for (int c = tid; c < kHalf * (kBN / 16); c += kGemmThreads) {
      const int pk = c / (kBN / 16);
      const int cc = (c % (kBN / 16)) * 16;
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
          q + ((size_t)g * kHalf + pk) * N + colt + cc));
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int wi = 0; wi < 4; ++wi) {
        const float4 lo = make_float4(nibble_lo(words[wi], 0), nibble_lo(words[wi], 1),
                                      nibble_lo(words[wi], 2), nibble_lo(words[wi], 3));
        const float4 hi = make_float4(nibble_hi(words[wi], 0), nibble_hi(words[wi], 1),
                                      nibble_hi(words[wi], 2), nibble_hi(words[wi], 3));
        *reinterpret_cast<float4*>(ws + pk * kBN + cc + 4 * wi) = lo;
        *reinterpret_cast<float4*>(ws + (pk + kHalf) * kBN + cc + 4 * wi) = hi;
      }
    }
    __syncthreads();

    float part[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) part[i][j] = 0.0f;
#pragma unroll 8
    for (int k = 0; k < kGroup; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(xs + k * kXStride + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(ws + k * kBN + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(ws + k * kBN + 64 + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) part[i][j] = fmaf(av[i], bv[j], part[i][j]);
    }
    const float* sg = scale + (size_t)g * N + colt;
    const float4 s0 = __ldg(reinterpret_cast<const float4*>(sg + tx * 4));
    const float4 s1 = __ldg(reinterpret_cast<const float4*>(sg + 64 + tx * 4));
    const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(part[i][j], sv[j], acc[i][j]);
    __syncthreads();  // xs/ws are refilled by the next group
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = colt + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      store_out(out + (size_t)row * N + col, acc[i][j]);
    }
  }
}

template <typename T, int RT>
int launch_gemv(const T* x, const uint8_t* q, const float* scale, T* out, float* partial,
                int rows, int K, int N, int ksplit, cudaStream_t stream) {
  const dim3 grid((N + kGemvCols - 1) / kGemvCols, ksplit, (rows + RT - 1) / RT);
  w4_gemv<T, RT><<<grid, kGemvThreads, 0, stream>>>(x, q, scale, out, partial, rows, K, N,
                                                   ksplit);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ksplit == 1) return (int)err;
  const size_t total = (size_t)rows * N;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  w4_reduce<T><<<blocks, 256, 0, stream>>>(partial, out, rows, N, ksplit);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* xv, const void* qv, const float* scale, void* outv, float* partial,
           int rows, int K, int N, int ksplit, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const uint8_t* q = static_cast<const uint8_t*>(qv);
  T* out = static_cast<T*>(outv);
  if (rows <= kGemvMaxRows * 8) {
    // Row chunks of 8 (fewer registers for 1, 2 or 4 rows).
    if (rows == 1) return launch_gemv<T, 1>(x, q, scale, out, partial, rows, K, N, ksplit, stream);
    if (rows == 2) return launch_gemv<T, 2>(x, q, scale, out, partial, rows, K, N, ksplit, stream);
    if (rows <= 4) return launch_gemv<T, 4>(x, q, scale, out, partial, rows, K, N, ksplit, stream);
    return launch_gemv<T, 8>(x, q, scale, out, partial, rows, K, N, ksplit, stream);
  }
  if (ksplit != 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(w4_gemm<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kGemmSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N / kBN, (rows + kBM - 1) / kBM);
  w4_gemm<T><<<grid, kGemmThreads, kGemmSmem, stream>>>(x, q, scale, out, rows, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. `partial` is f32 scratch of
// ksplit * rows * N floats (unused when ksplit == 1); rows <= 64 take the
// GEMV kernel, more rows the tiled one (which needs ksplit == 1). Returns
// the CUDA status of the launches (0 = success).
extern "C" int kllms_w4_matmul(const void* x, const void* q, const float* scale, void* out,
                               float* partial, int rows, int K, int N, int is_bf16,
                               int ksplit, void* stream) {
  if (rows <= 0 || K <= 0 || N <= 0 || K % (2 * kGroup) != 0 || N % kBN != 0 ||
      ksplit <= 0 || (K / kGroup) % ksplit != 0 || (ksplit > 1 && partial == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(x, q, scale, out, partial, rows, K, N, ksplit, s);
  return launch<float>(x, q, scale, out, partial, rows, K, N, ksplit, s);
}
