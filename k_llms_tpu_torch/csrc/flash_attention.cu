// Prefill flash attention for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel k_llms_tpu/ops/attention.py::_flash_kernel
// (entry flash_attention). Same contract:
//   q [B, QH, Sq, D], k/v [B, KVH, Sk, D] (bf16 or f32, contiguous),
//   out [B, QH, Sq, D] in q's dtype. Query head h reads kv head h / (QH/KVH).
//   A key column c is valid for query row r (absolute position
//   r + q_offset) iff  c < key_lengths[b]  and  c > pos - window  and,
//   when causal,  c <= pos. Scores are q.k * sm_scale, optionally
//   softcap * tanh(s / softcap), then an f32 online softmax over the valid
//   keys. A row with no valid key writes zeros.
//
// What bounds it on this card: at the main path's prefill (S ~ 1.5-2k,
// D = 128) attention is arithmetic-bound (about 2*S FLOPs per byte read),
// so the bf16 path runs on the tensor cores. Two kernels, chosen by the
// wrapper from dtype and head dim (ops/attention.py::flash_route):
//
//   * flash_attention_tc (bf16, D = 64, 128, 256): one CTA per (query tile,
//     query head, batch row), one warp per 16 query rows: 128-row tiles (8
//     warps) at D = 128, 64-row tiles (4 warps) at D = 64 and 256. K/V tiles of 64 keys (32 at D = 256) stream through a two-stage
//     shared-memory ring filled by cp.async, so the next tile's copy runs
//     under the current tile's products. S = Q K^T and O += P V are
//     mma.sync.m16n8k16 (bf16 operands, f32 accumulators) fed by ldmatrix;
//     the scores stay in registers, where the online softmax, the masks and
//     the softcap run in f32. The products of bf16 values are exact in f32,
//     so S is the Pallas kernel's up to summation order. P stays f32 in the
//     Pallas kernel; here it is split into P_hi = bf16(P) and
//     P_lo = bf16(P - P_hi), and both halves are multiplied into the same
//     f32 accumulator, which carries P to about 2^-16 of itself (a single
//     bf16 rounding, 2^-9, would not hold the port's two-ulp limit where
//     the output nearly cancels). Query tiles are launched heaviest first
//     (most causal key tiles), and tiles wholly above the diagonal, past
//     the key length or below the window are never loaded.
//   * flash_attention_simt (f32, and bf16 at D = 16): the first port's
//     kernel, f32 on the CUDA cores (TF32 would change f32 results):
//     4 threads per query row, K/V tiles of 32 keys widened to f32 in
//     shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

namespace {

using namespace kllms;

constexpr int kBlockQ = 64;       // query rows per CTA
constexpr int kBlockK = 32;       // keys per shared-memory tile (one bit each)
constexpr int kLanesPerRow = 4;   // threads cooperating on one query row
constexpr int kThreads = kBlockQ * kLanesPerRow;
constexpr float kNegInf = -3.4028234663852886e38f;  // finfo(float32).min

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16-byte vector load of kVec<T> consecutive elements, widened to f32.
template <typename T>
struct VecLoad;
template <>
struct VecLoad<float> {
  static constexpr int kVec = 4;
  __device__ __forceinline__ static void load(const float* src, float* dst) {
    const float4 raw = __ldg(reinterpret_cast<const float4*>(src));
    dst[0] = raw.x;
    dst[1] = raw.y;
    dst[2] = raw.z;
    dst[3] = raw.w;
  }
};
template <>
struct VecLoad<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* src, float* dst) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
    const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(pairs[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_simt(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       const int* __restrict__ key_lengths, int QH, int KVH,
                       int Sq, int Sk, float sm_scale, int causal,
                       float softcap, int window, int q_offset) {
  constexpr int DL = D / kLanesPerRow;  // head dims owned by one thread
  constexpr int kVec = VecLoad<T>::kVec;
  static_assert(D % kLanesPerRow == 0 && D % kVec == 0, "unsupported head dim");

  extern __shared__ float smem[];
  float* k_s = smem;                  // [kBlockK][D]
  float* v_s = smem + kBlockK * D;    // [kBlockK][D]

  const int qb = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (QH / KVH);
  const int tid = threadIdx.x;
  const int lane4 = tid % kLanesPerRow;
  const int row = qb * kBlockQ + tid / kLanesPerRow;
  const bool row_ok = row < Sq;
  const int pos = row + q_offset;  // absolute query position

  const T* q_row = q + (((size_t)b * QH + h) * Sq + (row_ok ? row : 0)) * D;
  const T* k_head = k + ((size_t)b * KVH + kvh) * (size_t)Sk * D;
  const T* v_head = v + ((size_t)b * KVH + kvh) * (size_t)Sk * D;

  float qr[DL];
  float acc[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) {
    qr[i] = to_f32(q_row[i * kLanesPerRow + lane4]);
    acc[i] = 0.f;
  }
  float m = kNegInf;  // running max over valid scores
  float l = 0.f;      // running softmax denominator at m

  int klen = key_lengths[b];
  klen = klen < 0 ? 0 : (klen > Sk ? Sk : klen);
  // Key range any row of this block can see (the per-element test below is
  // exact; this only skips tiles that are wholly masked).
  const int first_pos = qb * kBlockQ + q_offset;
  int k_end = klen;
  if (causal) k_end = min(k_end, first_pos + kBlockQ);
  int k_begin = first_pos - window + 1;
  k_begin = k_begin < 0 ? 0 : (k_begin / kBlockK) * kBlockK;

  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = tid * kVec; idx < kBlockK * D; idx += kThreads * kVec) {
      const int col = k0 + idx / D;
      const int d = idx % D;
      if (col < Sk) {
        VecLoad<T>::load(k_head + (size_t)col * D + d, k_s + idx);
        VecLoad<T>::load(v_head + (size_t)col * D + d, v_s + idx);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          k_s[idx + e] = 0.f;
          v_s[idx + e] = 0.f;
        }
      }
    }
    __syncthreads();

    float s[kBlockK];
    unsigned valid_bits = 0u;
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float* kr = k_s + j * D;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DL; ++i) part = fmaf(qr[i], kr[i * kLanesPerRow + lane4], part);
      // The 4 lanes of a row are adjacent: a butterfly gives each the sum.
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      float sc = part * sm_scale;
      if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
      const int col = k0 + j;
      bool ok = row_ok && col < klen && col > pos - window;
      if (causal) ok = ok && col <= pos;
      s[j] = sc;
      if (ok) {
        valid_bits |= 1u << j;
        tile_max = fmaxf(tile_max, sc);
      }
    }
    const float m_new = fmaxf(m, tile_max);
    if (valid_bits != 0u) {
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[i] *= alpha;
#pragma unroll
      for (int j = 0; j < kBlockK; ++j) {
        const float p = ((valid_bits >> j) & 1u) ? expf(s[j] - m_new) : 0.f;
        psum += p;
        const float* vr = v_s + j * D;
#pragma unroll
        for (int i = 0; i < DL; ++i) acc[i] = fmaf(p, vr[i * kLanesPerRow + lane4], acc[i]);
      }
      l = l * alpha + psum;
      m = m_new;
    }
  }

  if (row_ok) {
    T* o = out + (((size_t)b * QH + h) * Sq + row) * D;
    const bool any = m != kNegInf;
    const float denom = l == 0.f ? 1.f : l;
#pragma unroll
    for (int i = 0; i < DL; ++i) {
      o[i * kLanesPerRow + lane4] = from_f32<T>(any ? acc[i] / denom : 0.f);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           const int* key_lengths, int B, int QH, int KVH, int Sq, int Sk,
           float sm_scale, int causal, float softcap, int window, int q_offset,
           cudaStream_t stream) {
  const size_t smem = 2 * (size_t)kBlockK * D * sizeof(float);
  auto kernel = flash_attention_simt<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, QH, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), key_lengths, QH, KVH, Sq, Sk, sm_scale, causal,
      softcap, window, q_offset);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dim(int D, const void* q, const void* k, const void* v, void* out,
                 const int* key_lengths, int B, int QH, int KVH, int Sq, int Sk,
                 float sm_scale, int causal, float softcap, int window,
                 int q_offset, cudaStream_t stream) {
  if (D == 16) {
    return launch<T, 16>(q, k, v, out, key_lengths, B, QH, KVH, Sq, Sk, sm_scale, causal,
                         softcap, window, q_offset, stream);
  }
  if constexpr (std::is_same<T, float>::value) {
    switch (D) {
      case 64:
        return launch<T, 64>(q, k, v, out, key_lengths, B, QH, KVH, Sq, Sk, sm_scale, causal,
                             softcap, window, q_offset, stream);
      case 128:
        return launch<T, 128>(q, k, v, out, key_lengths, B, QH, KVH, Sq, Sk, sm_scale, causal,
                              softcap, window, q_offset, stream);
      case 256:
        return launch<T, 256>(q, k, v, out, key_lengths, B, QH, KVH, Sq, Sk, sm_scale, causal,
                              softcap, window, q_offset, stream);
    }
  }
  // bf16 at the larger head dims takes the tensor-core kernel.
  return (int)cudaErrorInvalidValue;
}

// --- bf16 on the tensor cores -------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct TcTile {
  // Query rows per CTA: 128 (8 warps) halves the K/V tiles each query row
  // copies at D = 128; at D = 64 and 256 the 64-row tile measured faster.
  static constexpr int kBlockM = D == 128 ? 128 : 64;
  static constexpr int kThreads = kBlockM / 16 * 32;  // one warp per 16 rows
  static constexpr int kBlockN = D == 256 ? 32 : 64;  // keys per K/V tile
  static constexpr int kStride = D + 8;  // bf16 per shared row: the 16-byte pad puts
                                         // the 8 rows an ldmatrix reads on distinct banks
  // Q fragments stay in registers up to D = 128; at D = 256 the output
  // accumulator takes 128 registers and Q is read from shared memory.
  static constexpr bool kQInRegs = D <= 128;
  static constexpr size_t kSmemBytes =
      (size_t)(kBlockM + 2 /*stages*/ * 2 /*K, V*/ * kBlockN) * kStride * sizeof(__nv_bfloat16);
};

// grid (QH, ceil(Sq / kBlockM), B); blockIdx.y counts query tiles from the last
// (the one with the most causal key tiles) down.
template <int D>
__global__ void __launch_bounds__(TcTile<D>::kThreads)
flash_attention_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                   const int* __restrict__ key_lengths, int QH, int KVH, int Sq, int Sk,
                   float sm_scale, int causal, float softcap, int window, int q_offset) {
  using Tile = TcTile<D>;
  constexpr int BM = Tile::kBlockM;
  constexpr int BN = Tile::kBlockN;
  constexpr int ST = Tile::kStride;
  constexpr int KD = D / 16;  // k-steps of S = Q K^T
  constexpr int NT = BN / 8;  // 8-key column tiles of S
  constexpr int DT = D / 8;   // 8-wide column tiles of O
  constexpr int CH = D / 8;   // 16-byte chunks per row

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BM][ST]
  __nv_bfloat16* kv_s = q_s + BM * ST;  // [stage][K, V][BN][ST]

  const int h = blockIdx.x;
  const int qb = gridDim.y - 1 - blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (QH / KVH);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = qb * BM;

  const __nv_bfloat16* q_head = q + ((size_t)b * QH + h) * (size_t)Sq * D;
  const __nv_bfloat16* k_head = k + ((size_t)b * KVH + kvh) * (size_t)Sk * D;
  const __nv_bfloat16* v_head = v + ((size_t)b * KVH + kvh) * (size_t)Sk * D;

  int klen = key_lengths[b];
  klen = klen < 0 ? 0 : (klen > Sk ? Sk : klen);
  // Key range any row of this tile can see (the per-element test below is
  // exact; this only skips tiles that are wholly masked).
  const int first_pos = row0 + q_offset;
  const int last_pos = first_pos + BM - 1;
  int k_end = klen;
  if (causal) k_end = min(k_end, last_pos + 1);
  int k_begin = first_pos - window + 1;
  k_begin = k_begin < 0 ? 0 : (k_begin / BN) * BN;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0;

  // Q tile; rows past Sq are zero-filled (their outputs are not written).
  for (int c = tid; c < BM * CH; c += Tile::kThreads) {
    const int r = c / CH;
    const int ch = c % CH;
    const bool ok = row0 + r < Sq;
    cp_async_16(q_s + r * ST + ch * 8, q_head + (size_t)(ok ? row0 + r : 0) * D + ch * 8,
                ok ? 16 : 0);
  }
  // K/V tile `tile` into ring stage `stage`. Keys at or past the key length
  // are zero-filled and never read, so padding of any value (NaN included)
  // meets an exact zero weight.
  auto load_kv = [&](int tile, int stage) {
    const int k0 = k_begin + tile * BN;
    __nv_bfloat16* ks = kv_s + stage * 2 * BN * ST;
    __nv_bfloat16* vs = ks + BN * ST;
    for (int c = tid; c < BN * CH; c += Tile::kThreads) {
      const int r = c / CH;
      const int ch = c % CH;
      const bool ok = k0 + r < klen;
      const size_t off = (size_t)(ok ? k0 + r : 0) * D + ch * 8;
      cp_async_16(ks + r * ST + ch * 8, k_head + off, ok ? 16 : 0);
      cp_async_16(vs + r * ST + ch * 8, v_head + off, ok ? 16 : 0);
    }
  };
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();

  uint32_t qf[Tile::kQInRegs ? KD : 1][4];
  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max (log2 units), rows g and g + 8
  float l[2] = {0.f, 0.f};              // this thread's share of the running sums
  const int wrow = warp * 16;           // the warp's first row in the tile
  const int pos0 = first_pos + wrow + g;  // absolute position of row g (and + 8)
  const __nv_bfloat16* q_frag_base = q_s + (wrow + (lane & 15)) * ST + (lane >> 4) * 8;

  for (int it = 0; it < n_tiles; ++it) {
    __syncthreads();  // every warp is done with the stage the next copy refills
    if (it + 1 < n_tiles) load_kv(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile `it` (and at it == 0 the Q tile) is in shared memory

    if (Tile::kQInRegs && it == 0) {
#pragma unroll
      for (int kd = 0; kd < (Tile::kQInRegs ? KD : 0); ++kd) ldmatrix_x4(qf[kd], q_frag_base + kd * 16);
    }
    const __nv_bfloat16* ks = kv_s + (it & 1) * 2 * BN * ST;
    const __nv_bfloat16* vs = ks + BN * ST;
    const int k0 = k_begin + it * BN;

    // S = Q K^T for the warp's 16 rows x BN keys.
    float s[NT][4];  // started by the first k-step
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t qa[4];
      if (Tile::kQInRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = qf[Tile::kQInRegs ? kd : 0][i];
      } else {
        ldmatrix_x4(qa, q_frag_base + kd * 16);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        // Keys np*16 .. +15 at head dims kd*16 .. +15: two B fragments.
        uint32_t kb[4];
        ldmatrix_x4(kb, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * ST + kd * 16 +
                            ((lane >> 3) & 1) * 8);
        if (kd == 0) {
          mma_bf16_zero(s[2 * np], qa, kb[0], kb[1]);
          mma_bf16_zero(s[2 * np + 1], qa, kb[2], kb[3]);
        } else {
          mma_bf16(s[2 * np], qa, kb[0], kb[1]);
          mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
        }
      }
    }

    // Scale, softcap, mask (f32, in registers), in log2 units.
    const bool full = k0 + BN <= klen && (!causal || k0 + BN - 1 <= first_pos) &&
                      k0 > last_pos - window;
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * sm_scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        x *= kLog2e;
        if (!full) {
          const int col = k0 + nt * 8 + 2 * t + (e & 1);
          const int pos = pos0 + (e >> 1) * 8;
          bool ok = col < klen && col > pos - window;
          if (causal) ok = ok && col <= pos;
          if (!ok) x = -INFINITY;
        }
        s[nt][e] = x;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], x);
      }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // The 4 lanes of a row are adjacent: a butterfly gives each the max.
      tile_max[i] = fmaxf(tile_max[i], __shfl_xor_sync(0xffffffffu, tile_max[i], 1));
      tile_max[i] = fmaxf(tile_max[i], __shfl_xor_sync(0xffffffffu, tile_max[i], 2));
      const float m_new = fmaxf(m[i], tile_max[i]);
      // A row with no valid key yet keeps m = -inf; exponents are then taken
      // against 0 so that masked scores give exp2(-inf) = 0, not NaN.
      m_use[i] = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = exp2f(m[i] - m_use[i]);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    // O += P V over 16-key steps. The score fragment of keys 16kk .. +15 is
    // the A fragment of the step; P = P_hi + P_lo, both bf16, both multiplied
    // into the f32 accumulator.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // j: (row g, keys 2t..), (row g+8, keys 2t..), (row g, keys 8+2t..), (row g+8, 8+2t..)
        const int nt = 2 * kk + (j >> 1);
        const int e = (j & 1) * 2;
        const float p0 = exp2f(s[nt][e] - m_use[j & 1]);
        const float p1 = exp2f(s[nt][e + 1] - m_use[j & 1]);
        l[j & 1] += p0 + p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 hf = __bfloat1622float2(hi);
        ph[j] = *reinterpret_cast<const uint32_t*>(&hi);
        pl[j] = pack_bf16x2(p0 - hf.x, p1 - hf.y);
      }
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        // Keys 16kk .. +15 at head dims dp*16 .. +15, transposed: two B fragments.
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ST + dp * 16 +
                                  (lane >> 4) * 8);
        mma_bf16(o[2 * dp], ph, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], ph, vb[2], vb[3]);
        mma_bf16(o[2 * dp], pl, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pl, vb[2], vb[3]);
      }
    }
  }
  cp_async_wait<0>();

  // Normalise; rows that never saw a valid key write zeros. The warp stages
  // its 16 rows in its own rows of the Q tile, then writes them out 16
  // bytes at a time.
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = m[i] == -INFINITY ? 0.f : 1.f / l[i];
  }
  __syncthreads();  // every warp is done reading the Q tile
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    __nv_bfloat16* r0 = q_s + (wrow + g) * ST + dt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(r0) = pack_bf16x2(o[dt][0] * inv[0], o[dt][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(r0 + 8 * ST) = pack_bf16x2(o[dt][2] * inv[1], o[dt][3] * inv[1]);
  }
  __syncwarp();
  __nv_bfloat16* o_head = out + ((size_t)b * QH + h) * (size_t)Sq * D;
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = wrow + c / CH;
    const int ch = c % CH;
    if (row0 + r < Sq) {
      *reinterpret_cast<uint4*>(o_head + (size_t)(row0 + r) * D + ch * 8) =
          *reinterpret_cast<const uint4*>(q_s + r * ST + ch * 8);
    }
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out, const int* key_lengths,
              int B, int QH, int KVH, int Sq, int Sk, float sm_scale, int causal, float softcap,
              int window, int q_offset, cudaStream_t stream) {
  const size_t smem = TcTile<D>::kSmemBytes;
  auto kernel = flash_attention_tc<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int q_tiles = (Sq + TcTile<D>::kBlockM - 1) / TcTile<D>::kBlockM;
  if (q_tiles > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(QH, q_tiles, B);
  kernel<<<grid, TcTile<D>::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), key_lengths, QH,
      KVH, Sq, Sk, sm_scale, causal, softcap, window, q_offset);
  return (int)cudaGetLastError();
}

int dispatch_tc(int D, const void* q, const void* k, const void* v, void* out,
                const int* key_lengths, int B, int QH, int KVH, int Sq, int Sk, float sm_scale,
                int causal, float softcap, int window, int q_offset, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch_tc<64>(q, k, v, out, key_lengths, B, QH, KVH, Sq, Sk, sm_scale, causal,
                           softcap, window, q_offset, stream);
    case 128:
      return launch_tc<128>(q, k, v, out, key_lengths, B, QH, KVH, Sq, Sk, sm_scale, causal,
                            softcap, window, q_offset, stream);
    case 256:
      return launch_tc<256>(q, k, v, out, key_lengths, B, QH, KVH, Sq, Sk, sm_scale, causal,
                            softcap, window, q_offset, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point for ctypes. `use_tc` picks the kernel (the wrapper
// decides from dtype and head dim; the tensor-core kernel takes bf16 at
// D = 64, 128 and 256 only). Returns the CUDA status of the launch
// (0 = success). softcap <= 0 disables the softcap.
extern "C" int kllms_flash_attention(const void* q, const void* k, const void* v,
                                     void* out, const int* key_lengths, int B,
                                     int QH, int KVH, int Sq, int Sk, int D,
                                     int is_bf16, int use_tc, float sm_scale, int causal,
                                     float softcap, int window, int q_offset,
                                     void* stream) {
  if (B <= 0 || QH <= 0 || KVH <= 0 || QH % KVH != 0 || Sq <= 0 || Sk <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_tc) {
    if (!is_bf16) return (int)cudaErrorInvalidValue;
    return dispatch_tc(D, q, k, v, out, key_lengths, B, QH, KVH, Sq, Sk, sm_scale, causal,
                       softcap, window, q_offset, s);
  }
  if (is_bf16) {
    return dispatch_dim<__nv_bfloat16>(D, q, k, v, out, key_lengths, B, QH, KVH, Sq,
                                       Sk, sm_scale, causal, softcap, window,
                                       q_offset, s);
  }
  return dispatch_dim<float>(D, q, k, v, out, key_lengths, B, QH, KVH, Sq, Sk,
                             sm_scale, causal, softcap, window, q_offset, s);
}
