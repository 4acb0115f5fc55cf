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
// registers or shared memory on chip.
//
// What bounds it on this card: bytes at decode rows, operations at prefill
// rows. At 1-32 rows every packed weight byte feeds 2-64 multiply-adds, far
// below the card's balance point, so the 4-bit weights are the traffic (half
// of int8, a quarter of bf16); at 512-2048 rows the product is compute
// bound. bf16 calls run on the tensor cores.
//
// Four kernels; the wrapper picks one from dtype and rows
// (ops/w4matmul.py::w4_route) and passes it as `route`:
//   * w4_decode_tc (route 3; bf16 rows up to the crossover: decode at
//     n <= 32 and the last-token logits): the operands are swapped so that
//     a few rows fill an MMA, out^T = W^T x^T with mma.sync.m16n8k16: 16
//     weight columns are M, up to 8 rows of x are N (1-7 rows pad the same
//     n8 tile; 2 or 4 n8 tiles at 9-32 rows), the contraction is K. A CTA of
//     4 warps owns 128 columns and streams its groups' packed bytes, scales
//     and x slice through a four-stage cp.async ring (about 36 KB in flight
//     a CTA, several CTAs an SM), reading each packed byte once. The same
//     ldmatrix.trans of the packed bytes as the prefill kernel's gives a
//     lane byte rows 2t, 2t + 1 (and 2t + 8, 2t + 9) of columns 2g and
//     2g + 1: with the even column as A row g and the odd one as A row
//     g + 8, their low and high nibbles are the A fragments of two k-steps
//     (contraction rows 64 apart) of one m16 tile. x is the B operand,
//     read by ldmatrix from shared memory. The per-column scale multiplies
//     an accumulator row. Each group's 8 k-steps go into a fresh f32
//     accumulator, which is scaled and added to the output accumulator.
//     Split K fills the card at small N; the last CTA of each column tile
//     (a counter in a semaphore array the wrapper keeps, reset by that
//     CTA) adds the f32 partials in split order, so one launch does it all
//     and the result does not depend on which CTA finishes last.
//   * w4_gemv (route 0; f32 rows <= 64): one warp walks one 128-row group at a time for a 256-column tile (8
//     columns per lane, one 8-byte load per packed row), with up to 8 rows
//     in registers, f32 on the CUDA cores (a nibble becomes a float by
//     OR-ing nibble ^ 8 into the mantissa of 2^23 and subtracting 2^23 + 8);
//     the CTA's 4 warps take different groups and add their sums in shared
//     memory.
//   * w4_gemm_tc (route 2; bf16 rows above the crossover): a 64- or
//     128-row x 128-column CTA tile walks the groups. The x tile, the
//     group's packed bytes and its scales stream through a three-stage
//     shared-memory ring filled by cp.async. An ldmatrix.trans of the
//     packed bytes hands each lane, in one register, byte rows 2t and
//     2t + 1 of two neighbouring columns: both nibbles of those bytes are
//     the B fragments of two k-steps (rows 64 apart) for two 8-column
//     tiles (the tile's even and odd columns). A nibble becomes a bf16
//     without a conversion: OR-ing (nibble ^ 8) into the mantissa of 128.0
//     and subtracting 136 (exact). Each group's 8 k-steps of
//     mma.sync.m16n8k16 (bf16 in, f32 accumulated) go into a fresh f32
//     accumulator, which is then scaled per column and added to the
//     output accumulator: the Pallas kernel's arithmetic, exactly.
//   * w4_gemm (route 1; f32 rows > 64): a 64 x 128 tile on the CUDA cores
//     (TF32 would change f32 results); the group's bytes are unpacked once
//     into a [128, 128] f32 shared tile.
// Routes 0 and 2 split long contractions over CTAs too (`ksplit`); their
// f32 partials w4_reduce adds in a fixed order.
//
// N need not fill the column tiles: every route masks its last column tile
// (a tensor-parallel shard such as Llama-3-8B's lm_head over 4 ranks,
// [4096, 32064], ends 64 columns into a 128-column tile). Loads past N are
// zero-filled (cp.async with a source size of 0) or skipped, and no store
// passes N. N must keep the packed rows 16-byte aligned (N % 16 == 0), so a
// 16-byte chunk of columns is wholly in or wholly out; K keeps whole
// 256-row blocks (the 128-row scale groups and the tile).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using namespace kllms;

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

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// --- few rows: GEMV-like ------------------------------------------------------

constexpr int kGemvWarps = 4;
constexpr int kGemvThreads = kGemvWarps * 32;
constexpr int kGemvCols = 256;  // 32 lanes x 8 columns

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
  const bool col_ok = col0 < N;  // N % 16 == 0: a lane's 8 columns are all in or out
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
    // Packed bytes [64, 128] -> ws[k][col] (f32): 16 bytes per load;
    // columns past N read as zero bytes (the masked last tile).
    for (int c = tid; c < kHalf * (kBN / 16); c += kGemmThreads) {
      const int pk = c / (kBN / 16);
      const int cc = (c % (kBN / 16)) * 16;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);  // nibble 0 is the value 0
      if (colt + cc < N)
        raw = __ldg(reinterpret_cast<const uint4*>(q + ((size_t)g * kHalf + pk) * N + colt + cc));
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
    const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 s0 = colt + tx * 4 < N ? __ldg(reinterpret_cast<const float4*>(sg + tx * 4)) : zero4;
    const float4 s1 =
        colt + 64 + tx * 4 < N ? __ldg(reinterpret_cast<const float4*>(sg + 64 + tx * 4)) : zero4;
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
      if (col < N) store_out(out + (size_t)row * N + col, acc[i][j]);
    }
  }
}

// --- prefill rows on the tensor cores (bf16 x) -------------------------------

constexpr int kTcBN = 128;                  // output columns per CTA
constexpr int kTcStages = 3;                // shared-memory ring depth
constexpr int kTcXStride = kGroup + 8;      // bf16 per x row in shared memory (pad:
                                            // ldmatrix rows on distinct banks)
constexpr int kTcQStride = kTcBN + 16;      // bytes per packed row (same reason)

template <int BM>
struct TcTile {
  static constexpr int kWarpsM = BM / 64;   // each warp: 64 rows x 32 columns
  static constexpr int kThreads = 32 * kWarpsM * 4;
  static constexpr int kXBytes = BM * kTcXStride * 2;
  static constexpr int kQBytes = kHalf * kTcQStride;
  static constexpr int kStageBytes = kXBytes + kQBytes + kTcBN * 4;
  static constexpr size_t kSmemBytes = (size_t)kTcStages * kStageBytes;
};

// Two nibbles (bits 0-3 and 16-19 of w, already XOR-ed with 8) -> two bf16
// with their signed values, the low half first.
__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t w) {
  const uint32_t biased = (w & 0x000F000Fu) | 0x43004300u;  // 128 + (nibble ^ 8)
  const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&biased),
                                   __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// grid (N / 128, ksplit, ceil(rows / BM)). Warp (wm, wn) owns rows
// wm*64 .. +64 of the tile (4 m-tiles of 16) and columns wn*32 .. +32 (2
// chunks of 16; in chunk c, 8-column tile 2c takes the even columns and
// 2c + 1 the odd ones).
template <int BM>
__global__ void __launch_bounds__(TcTile<BM>::kThreads)
w4_gemm_tc(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
           const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
           float* __restrict__ partial, int rows, int K, int N, int ksplit) {
  using Tile = TcTile<BM>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = warp >> 2;
  const int wn = warp & 3;
  const int col0 = blockIdx.x * kTcBN;
  const int row0 = blockIdx.z * BM;
  const int per_split = K / kGroup / ksplit;
  const int g_begin = blockIdx.y * per_split;

  auto stage_ptr = [&](int stage) { return smem_raw + stage * Tile::kStageBytes; };
  // Group g_begin + i into stage i % kTcStages: the x tile (rows past the
  // end zero-filled), the 64 x 128 packed bytes, the 128 scales.
  auto load_group = [&](int i) {
    unsigned char* base = stage_ptr(i % kTcStages);
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(base);
    unsigned char* qs = base + Tile::kXBytes;
    float* ss = reinterpret_cast<float*>(qs + Tile::kQBytes);
    const int gg = g_begin + i;
    for (int c = tid; c < BM * 16; c += Tile::kThreads) {
      const int r = c >> 4;
      const int ch = c & 15;
      const bool ok = row0 + r < rows;
      cp_async_16(xs + r * kTcXStride + ch * 8,
                  x + (size_t)(ok ? row0 + r : 0) * K + (size_t)gg * kGroup + ch * 8, ok ? 16 : 0);
    }
    // Columns past N (the masked last tile) are zero-filled.
    for (int c = tid; c < kHalf * 8; c += Tile::kThreads) {
      const int r = c >> 3;
      const int ch = c & 7;
      const bool in = col0 + ch * 16 < N;
      cp_async_16(qs + r * kTcQStride + ch * 16,
                  q + ((size_t)gg * kHalf + r) * N + (in ? col0 + ch * 16 : 0), in ? 16 : 0);
    }
    for (int c = tid; c < kTcBN / 4; c += Tile::kThreads) {
      const bool in = col0 + c * 4 < N;
      cp_async_16(ss + c * 4, scale + (size_t)gg * N + (in ? col0 + c * 4 : 0), in ? 16 : 0);
    }
  };

#pragma unroll
  for (int i = 0; i < kTcStages - 1; ++i) {
    if (i < per_split) load_group(i);
    cp_async_commit();
  }

  float acc[4][4][4];  // [m-tile][n-tile][fragment], the output accumulator
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b][0] = acc[a][b][1] = acc[a][b][2] = acc[a][b][3] = 0.f;

  for (int i = 0; i < per_split; ++i) {
    cp_async_wait<kTcStages - 2>();
    __syncthreads();  // group i has landed; every warp is done with group i - 1's stage
    if (i + kTcStages - 1 < per_split) load_group(i + kTcStages - 1);
    cp_async_commit();

    const unsigned char* base = stage_ptr(i % kTcStages);
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(base);
    const unsigned char* qs = base + Tile::kXBytes;
    const float* ss = reinterpret_cast<const float*>(qs + Tile::kQBytes);

    float part[4][4][4];  // this group's f32 sums, started by its first k-step

#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // Byte rows 16kk .. +15 (contraction rows 16kk .. +15 in the low
      // nibbles, 64 + 16kk .. +15 in the high ones) of the warp's 32
      // columns, as b16 pairs of neighbouring columns, transposed: raw[2c]
      // holds rows 2t, 2t+1 and raw[2c+1] rows 8+2t, 9+2t of columns
      // 16c + 2g and 16c + 2g + 1.
      uint32_t raw[4];
      ldmatrix_x4_trans(raw, qs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kTcQStride +
                                 wn * 32 + (lane >> 4) * 16);
      uint32_t bf[2][4][2];  // [low / high nibbles][n-tile][b0, b1]
#pragma unroll
      for (int c = 0; c < 2; ++c) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint32_t w = raw[2 * c + j] ^ 0x88888888u;
          bf[0][2 * c][j] = nibbles_to_bf16x2(w);            // even column, low nibble
          bf[1][2 * c][j] = nibbles_to_bf16x2(w >> 4);       // even column, high nibble
          bf[0][2 * c + 1][j] = nibbles_to_bf16x2(w >> 8);   // odd column, low nibble
          bf[1][2 * c + 1][j] = nibbles_to_bf16x2(w >> 12);  // odd column, high nibble
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          uint32_t a[4];
          ldmatrix_x4(a, xs + (wm * 64 + mt * 16 + (lane & 15)) * kTcXStride + half * kHalf +
                             kk * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            if (kk == 0 && half == 0) {
              mma_bf16_zero(part[mt][nt], a, bf[half][nt][0], bf[half][nt][1]);
            } else {
              mma_bf16(part[mt][nt], a, bf[half][nt][0], bf[half][nt][1]);
            }
          }
        }
      }
    }
    // Fold the group in at its scales: lane (g, t) holds, in chunk c,
    // columns 16c + 4t (even tile, fragment 0), + 1 (odd tile, 0), + 2
    // (even, 1) and + 3 (odd, 1), for rows g and g + 8.
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float4 sv = *reinterpret_cast<const float4*>(ss + wn * 32 + c * 16 + 4 * t);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        acc[mt][2 * c][0] = fmaf(part[mt][2 * c][0], sv.x, acc[mt][2 * c][0]);
        acc[mt][2 * c][1] = fmaf(part[mt][2 * c][1], sv.z, acc[mt][2 * c][1]);
        acc[mt][2 * c][2] = fmaf(part[mt][2 * c][2], sv.x, acc[mt][2 * c][2]);
        acc[mt][2 * c][3] = fmaf(part[mt][2 * c][3], sv.z, acc[mt][2 * c][3]);
        acc[mt][2 * c + 1][0] = fmaf(part[mt][2 * c + 1][0], sv.y, acc[mt][2 * c + 1][0]);
        acc[mt][2 * c + 1][1] = fmaf(part[mt][2 * c + 1][1], sv.w, acc[mt][2 * c + 1][1]);
        acc[mt][2 * c + 1][2] = fmaf(part[mt][2 * c + 1][2], sv.y, acc[mt][2 * c + 1][2]);
        acc[mt][2 * c + 1][3] = fmaf(part[mt][2 * c + 1][3], sv.w, acc[mt][2 * c + 1][3]);
      }
    }
  }
  cp_async_wait<0>();

  // Four consecutive columns per (m-tile, chunk, row half) and lane.
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + wm * 64 + mt * 16 + g + hr * 8;
      if (row >= rows) continue;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = col0 + wn * 32 + c * 16 + 4 * t;
        if (col >= N) continue;  // the masked last tile: 4 columns wholly in or out
        const float v0 = acc[mt][2 * c][2 * hr];
        const float v1 = acc[mt][2 * c + 1][2 * hr];
        const float v2 = acc[mt][2 * c][2 * hr + 1];
        const float v3 = acc[mt][2 * c + 1][2 * hr + 1];
        if (ksplit == 1) {
          uint2 packed;
          packed.x = pack_bf16x2(v0, v1);
          packed.y = pack_bf16x2(v2, v3);
          *reinterpret_cast<uint2*>(out + (size_t)row * N + col) = packed;
        } else {
          *reinterpret_cast<float4*>(partial + ((size_t)blockIdx.y * rows + row) * N + col) =
              make_float4(v0, v1, v2, v3);
        }
      }
    }
  }
}

template <int BM>
int launch_tc(const __nv_bfloat16* x, const uint8_t* q, const float* scale, __nv_bfloat16* out,
              float* partial, int rows, int K, int N, int ksplit, cudaStream_t stream) {
  const size_t smem = TcTile<BM>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(w4_gemm_tc<BM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int row_tiles = (rows + BM - 1) / BM;
  if (row_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kTcBN - 1) / kTcBN, ksplit, row_tiles);
  w4_gemm_tc<BM><<<grid, TcTile<BM>::kThreads, smem, stream>>>(x, q, scale, out, partial, rows,
                                                                K, N, ksplit);
  err = cudaGetLastError();
  if (err != cudaSuccess || ksplit == 1) return (int)err;
  const size_t total = (size_t)rows * N;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  w4_reduce<__nv_bfloat16><<<blocks, 256, 0, stream>>>(partial, out, rows, N, ksplit);
  return (int)cudaGetLastError();
}

// --- decode rows on the tensor cores (bf16 x, up to 32 rows) ---------------

constexpr int kDecBN = 128;                // output columns per CTA
constexpr int kDecThreads = kDecBN;        // one warp per 32 columns
constexpr int kDecStages = 4;              // shared-memory ring depth
constexpr int kDecQStride = kDecBN + 16;   // bytes per packed row in shared memory (pad:
                                           // ldmatrix rows on distinct banks)
constexpr int kDecXStride = kGroup + 8;    // bf16 per x row in shared memory (same reason)

template <int NT>
struct DecTile {
  static constexpr int kRows = 8 * NT;     // x rows per n8 tile, padded
  static constexpr int kQBytes = kHalf * kDecQStride;
  static constexpr int kSBytes = kDecBN * 4;
  static constexpr int kXBytes = kRows * kDecXStride * 2;
  static constexpr int kStageBytes = kQBytes + kSBytes + kXBytes;
  static constexpr size_t kSmemBytes = (size_t)kDecStages * kStageBytes;
};

// grid (N / 128, ksplit). CTA (ct, ks) sums the groups [ks * G / ksplit,
// (ks + 1) * G / ksplit) for columns ct*128 .. +128 and every row. Warp w
// owns columns ct*128 + 32w .. +32: m16 tile c (c = 0, 1) holds columns
// 32w + 16c + 2i as A row i and 32w + 16c + 2i + 1 as A row i + 8.
template <int NT>
__global__ void __launch_bounds__(kDecThreads)
w4_decode_tc(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
             const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
             float* __restrict__ partial, int* __restrict__ sem, int rows, int K, int N,
             int ksplit) {
  using Tile = DecTile<NT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int is_last;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int col0 = blockIdx.x * kDecBN;
  const int per_split = K / kGroup / ksplit;
  const int g_begin = blockIdx.y * per_split;

  auto stage_ptr = [&](int i) { return smem_raw + (i % kDecStages) * Tile::kStageBytes; };
  // Group g_begin + i into its stage: 64 x 128 packed bytes, 128 scales and
  // the group's 128 columns of x (rows past the end zero-filled).
  auto load_group = [&](int i) {
    unsigned char* qs = stage_ptr(i);
    float* ss = reinterpret_cast<float*>(qs + Tile::kQBytes);
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(qs + Tile::kQBytes + Tile::kSBytes);
    const int gg = g_begin + i;
    // Columns past N (the masked last tile) are zero-filled.
    for (int c = tid; c < kHalf * (kDecBN / 16); c += kDecThreads) {
      const int r = c / (kDecBN / 16);
      const int ch = c % (kDecBN / 16);
      const bool in = col0 + ch * 16 < N;
      cp_async_16(qs + r * kDecQStride + ch * 16,
                  q + ((size_t)gg * kHalf + r) * N + (in ? col0 + ch * 16 : 0), in ? 16 : 0);
    }
    if (tid < kDecBN / 4) {
      const bool in = col0 + tid * 4 < N;
      cp_async_16(ss + tid * 4, scale + (size_t)gg * N + (in ? col0 + tid * 4 : 0), in ? 16 : 0);
    }
    for (int c = tid; c < Tile::kRows * (kGroup / 8); c += kDecThreads) {
      const int r = c >> 4;
      const int ch = c & 15;
      const bool ok = r < rows;
      cp_async_16(xs + r * kDecXStride + ch * 8,
                  x + (size_t)(ok ? r : 0) * K + (size_t)gg * kGroup + ch * 8, ok ? 16 : 0);
    }
  };

#pragma unroll
  for (int i = 0; i < kDecStages - 1; ++i) {
    if (i < per_split) load_group(i);
    cp_async_commit();
  }

  float acc[2][NT][4];  // [m16 tile][n8 tile][fragment], the output accumulator
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[c][n][0] = acc[c][n][1] = acc[c][n][2] = acc[c][n][3] = 0.f;

  for (int i = 0; i < per_split; ++i) {
    cp_async_wait<kDecStages - 2>();
    __syncthreads();  // group i has landed; every warp is done with group i - 1's stage
    if (i + kDecStages - 1 < per_split) load_group(i + kDecStages - 1);
    cp_async_commit();

    const unsigned char* qs = stage_ptr(i);
    const float* ss = reinterpret_cast<const float*>(qs + Tile::kQBytes);
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(qs + Tile::kQBytes + Tile::kSBytes);

    float part[2][NT][4];  // this group's f32 sums, started by its first k-step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // Byte rows 16kk .. +15 of the warp's 32 columns: raw[2c] holds rows
      // 2t, 2t+1 and raw[2c+1] rows 8+2t, 9+2t of columns 32w + 16c + 2g
      // and + 1 (as in w4_gemm_tc).
      uint32_t raw[4];
      ldmatrix_x4_trans(raw, qs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kDecQStride +
                                 warp * 32 + (lane >> 4) * 16);
      uint32_t a[2][2][4];  // [m16 tile][low / high nibbles][a0..a3]
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const uint32_t w0 = raw[2 * c] ^ 0x88888888u;
        const uint32_t w1 = raw[2 * c + 1] ^ 0x88888888u;
        a[c][0][0] = nibbles_to_bf16x2(w0);        // row g (even column), k 2t..
        a[c][0][1] = nibbles_to_bf16x2(w0 >> 8);   // row g + 8 (odd column), k 2t..
        a[c][0][2] = nibbles_to_bf16x2(w1);        // row g, k 2t + 8..
        a[c][0][3] = nibbles_to_bf16x2(w1 >> 8);   // row g + 8, k 2t + 8..
        a[c][1][0] = nibbles_to_bf16x2(w0 >> 4);   // the same, contraction rows + 64
        a[c][1][1] = nibbles_to_bf16x2(w0 >> 12);
        a[c][1][2] = nibbles_to_bf16x2(w1 >> 4);
        a[c][1][3] = nibbles_to_bf16x2(w1 >> 12);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        // x rows 8n .. +7 at group columns 16kk .. +15 (xb[0], xb[1]) and
        // 64 + 16kk .. +15 (xb[2], xb[3]): the B fragments of both k-steps.
        uint32_t xb[4];
        ldmatrix_x4(xb, xs + (n * 8 + (lane & 7)) * kDecXStride + 16 * kk +
                            ((lane >> 3) & 1) * 8 + (lane >> 4) * kHalf);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (kk == 0) {
            mma_bf16_zero(part[c][n], a[c][0], xb[0], xb[1]);
          } else {
            mma_bf16(part[c][n], a[c][0], xb[0], xb[1]);
          }
          mma_bf16(part[c][n], a[c][1], xb[2], xb[3]);
        }
      }
    }
    // Fold the group in at its scales: accumulator rows g and g + 8 are
    // columns 32w + 16c + 2g and + 1.
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float2 sv = *reinterpret_cast<const float2*>(ss + warp * 32 + c * 16 + 2 * g);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[c][n][0] = fmaf(part[c][n][0], sv.x, acc[c][n][0]);
        acc[c][n][1] = fmaf(part[c][n][1], sv.x, acc[c][n][1]);
        acc[c][n][2] = fmaf(part[c][n][2], sv.y, acc[c][n][2]);
        acc[c][n][3] = fmaf(part[c][n][3], sv.y, acc[c][n][3]);
      }
    }
  }
  cp_async_wait<0>();

  // Lane (g, t) holds rows 8n + 2t (fragments 0, 2) and 8n + 2t + 1 (1, 3)
  // at columns 32w + 16c + 2g and + 1.
  float* my_part = partial + (size_t)blockIdx.y * rows * N;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = n * 8 + 2 * t + hr;
        if (row >= rows) continue;
        const int col = col0 + warp * 32 + c * 16 + 2 * g;
        if (col >= N) continue;  // the masked last tile
        const float v0 = acc[c][n][hr];
        const float v1 = acc[c][n][2 + hr];
        if (ksplit == 1) {
          *reinterpret_cast<uint32_t*>(out + (size_t)row * N + col) = pack_bf16x2(v0, v1);
        } else {
          *reinterpret_cast<float2*>(my_part + (size_t)row * N + col) = make_float2(v0, v1);
        }
      }
    }
  }
  if (ksplit == 1) return;

  // The last CTA of the column tile adds the splits' partials in split order.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    is_last = atomicAdd(sem + blockIdx.x, 1) == ksplit - 1;
    if (is_last) atomicExch(sem + blockIdx.x, 0);  // ready for the next launch
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int idx = tid; idx < rows * (kDecBN / 4); idx += kDecThreads) {
    const int row = idx / (kDecBN / 4);
    const int col = col0 + (idx % (kDecBN / 4)) * 4;
    if (col >= N) continue;  // the masked last tile
    // The splits' loads are issued ahead of their (ordered) sum.
    constexpr int kUnroll = 8;
    const float4* src = reinterpret_cast<const float4*>(partial + (size_t)row * N + col);
    const size_t stride = (size_t)rows * N / 4;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < ksplit; s0 += kUnroll) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        v[u] = s0 + u < ksplit ? __ldcg(src + (s0 + u) * stride) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        sum.x += v[u].x;
        sum.y += v[u].y;
        sum.z += v[u].z;
        sum.w += v[u].w;
      }
    }
    uint2 packed;
    packed.x = pack_bf16x2(sum.x, sum.y);
    packed.y = pack_bf16x2(sum.z, sum.w);
    *reinterpret_cast<uint2*>(out + (size_t)row * N + col) = packed;
  }
}

template <int NT>
int launch_decode(const __nv_bfloat16* x, const uint8_t* q, const float* scale,
                  __nv_bfloat16* out, float* partial, int* sem, int rows, int K, int N,
                  int ksplit, cudaStream_t stream) {
  const size_t smem = DecTile<NT>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(w4_decode_tc<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kDecBN - 1) / kDecBN, ksplit);
  w4_decode_tc<NT><<<grid, kDecThreads, smem, stream>>>(x, q, scale, out, partial, sem, rows, K,
                                                        N, ksplit);
  return (int)cudaGetLastError();
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

// f32 x on the CUDA cores: route 0 (GEMV, row chunks of 8; fewer registers
// for 1, 2 or 4 rows) or route 1 (tiled, ksplit == 1).
int launch_f32(const float* x, const uint8_t* q, const float* scale, float* out, float* partial,
               int rows, int K, int N, int route, int ksplit, cudaStream_t stream) {
  if (route == 0) {
    if (rows == 1) return launch_gemv<float, 1>(x, q, scale, out, partial, rows, K, N, ksplit, stream);
    if (rows == 2) return launch_gemv<float, 2>(x, q, scale, out, partial, rows, K, N, ksplit, stream);
    if (rows <= 4) return launch_gemv<float, 4>(x, q, scale, out, partial, rows, K, N, ksplit, stream);
    return launch_gemv<float, 8>(x, q, scale, out, partial, rows, K, N, ksplit, stream);
  }
  if (ksplit != 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(w4_gemm<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kGemmSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kBN - 1) / kBN, (rows + kBM - 1) / kBM);
  w4_gemm<float><<<grid, kGemmThreads, kGemmSmem, stream>>>(x, q, scale, out, rows, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. `route` is the kernel the wrapper chose:
// 0 the GEMV kernel (f32 x), 1 the tiled kernel (f32 x, ksplit == 1), 2 the
// tensor-core kernel (bf16 x; 64-row tiles when rows <= 64, else 128), 3 the
// decode kernel (bf16 x, rows <= 32). `partial` is f32 scratch of
// ksplit * rows * N floats (unused when ksplit == 1); `sem` (route 3 with
// ksplit > 1) is ceil(N / 128) ints, zero before the launch and zero after
// it. K % 256 == 0 and N % 16 == 0.
// Returns the CUDA status of the launches (0 = success).
extern "C" int kllms_w4_matmul(const void* x, const void* q, const float* scale, void* out,
                               float* partial, int* sem, int rows, int K, int N, int is_bf16,
                               int route, int ksplit, void* stream) {
  if (rows <= 0 || K <= 0 || N <= 0 || K % (2 * kGroup) != 0 || N % 16 != 0 ||
      ksplit <= 0 || (K / kGroup) % ksplit != 0 || (ksplit > 1 && partial == nullptr) ||
      route < 0 || route > 3 || (route >= 2) != (is_bf16 != 0) ||
      (route == 3 && (rows > 32 || (ksplit > 1 && sem == nullptr)))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route >= 2) {
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    const uint8_t* qb = static_cast<const uint8_t*>(q);
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
    if (route == 3) {
      if (rows <= 8) return launch_decode<1>(xb, qb, scale, ob, partial, sem, rows, K, N, ksplit, s);
      if (rows <= 16) return launch_decode<2>(xb, qb, scale, ob, partial, sem, rows, K, N, ksplit, s);
      return launch_decode<4>(xb, qb, scale, ob, partial, sem, rows, K, N, ksplit, s);
    }
    if (rows <= 64) return launch_tc<64>(xb, qb, scale, ob, partial, rows, K, N, ksplit, s);
    return launch_tc<128>(xb, qb, scale, ob, partial, rows, K, N, ksplit, s);
  }
  return launch_f32(static_cast<const float*>(x), static_cast<const uint8_t*>(q), scale,
                    static_cast<float*>(out), partial, rows, K, N, route, ksplit, s);
}
