// Shared-prefix decode attention for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel
// k_llms_tpu/ops/attention.py::_decode_prefix_kernel (entry
// decode_prefix_attention). Same contract, one query position per row:
//   q [B, QH, D] (rows request-major: row b belongs to request b / (B / R));
//   prefix_k / prefix_v [R, P, KVH, D]; prompt_lens [R] (each in [1, P]);
//   out [B, QH, D] f32, normalized within the prefix;
//   m [B, QH] f32, the max of the scaled scores over the valid keys;
//   l [B, QH] f32, the softmax denominator at m.
// Key c of request r is valid iff c < prompt_lens[r]; invalid scores are set
// to the float32 minimum before the max, so they add an exact 0. The caller
// merges (out, m, l) with the generated tail (models/llama.py,
// _merge_prefix_tail).
//
// What bounds it on this card: bytes. Each prefix key feeds 4 * D FLOPs per
// query row, a few hundred FLOPs per byte at n * G = 32 rows: still under the
// card's balance point for bf16 tensor cores, so the least time is the
// prefix read once. The design reads it once per (request, kv head) for all
// of that request's n * G query rows, where the paged kernel
// (paged_decode.cu) reads it once per row:
//   * one CTA per (request, kv head, tile of 32 query rows); query row i of
//     the tile is batch row r * n + i / G, query head h * G + i % G, indexed
//     in place (no transpose);
//   * keys stream through shared memory in blocks of 64, widened to f32 with
//     16-byte loads, rows padded to D + 4 floats; keys at or past the prompt
//     length are not read (zeros in shared memory, masked scores), and key
//     blocks past it are skipped, which leaves the result unchanged exactly;
//   * each of 128 threads holds a 4 x 4 block of scores and a 4-row slice of
//     the output accumulator in registers, and the online-softmax state of
//     its 4 rows (max, denominator) in registers too; the 16 threads that
//     share rows reduce with warp shuffles.
// The math is f32 on the CUDA cores. At one request only KVH = 8 CTAs run on
// the card's 132 SMs, so a long prefix is latency bound on 8 SMs: splitting
// the key blocks over CTAs and merging their (out, m, l) is the redesign's
// work, and the (m, l) outputs make that split a local change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 32;  // query rows per CTA
constexpr int kKeys = 64;  // keys per block
constexpr int kPStride = kRows + 4;
constexpr float kNegInf = -3.4028234663852886e38f;  // finfo(float32).min

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* src, float* dst) {
    const float4 raw = __ldg(reinterpret_cast<const float4*>(src));
    dst[0] = raw.x;
    dst[1] = raw.y;
    dst[2] = raw.z;
    dst[3] = raw.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
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

// Column e (of D / 16) owned by thread column-group kg in the P.V phase.
template <int D>
__device__ __forceinline__ int col_of(int kg, int e) {
  if constexpr (D >= 64) {
    return 64 * (e / 4) + kg * 4 + (e % 4);
  } else {
    return kg * (D / 16) + e;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_prefix_kernel(const T* __restrict__ q, const T* __restrict__ pk,
                     const T* __restrict__ pv, const int* __restrict__ prompt_lens,
                     float* __restrict__ out, float* __restrict__ m_out,
                     float* __restrict__ l_out, int QH, int KVH, int n_per, int P,
                     float sm_scale) {
  constexpr int kStride = D + 4;
  constexpr int kNC = D / 16;  // output columns per thread
  constexpr int kVec = Vec<T>::kN;
  extern __shared__ float smem[];
  float* qs = smem;                       // [kRows][kStride]
  float* ks = qs + kRows * kStride;       // [kKeys][kStride]
  float* vs = ks + kKeys * kStride;       // [kKeys][kStride]
  float* pT = vs + kKeys * kStride;       // [kKeys][kPStride]

  const int tid = threadIdx.x;
  const int rg = tid / 16;  // rows rg*4 .. +4 of the tile
  const int kg = tid % 16;  // keys kg + 16*j of a block; columns col_of(kg, e)
  const int r = blockIdx.x / KVH;
  const int h = blockIdx.x % KVH;
  const int G = QH / KVH;
  const int QR = n_per * G;
  const int tile0 = blockIdx.y * kRows;
  const int plen = min(prompt_lens[r], P);

  // Query tile -> qs (f32); rows past QR are zeros.
  for (int c = tid; c < kRows * (D / kVec); c += kThreads) {
    const int i = c / (D / kVec);
    const int d = (c % (D / kVec)) * kVec;
    float vals[kVec];
    const int qi = tile0 + i;
    if (qi < QR) {
      const int b = r * n_per + qi / G;
      const int qh = h * G + qi % G;
      Vec<T>::load(q + ((size_t)b * QH + qh) * D + d, vals);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) vals[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) qs[i * kStride + d + e] = vals[e];
  }

  float m[4], l[4], acc[4][kNC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < kNC; ++e) acc[i][e] = 0.0f;
  }

  const int nblocks = (plen + kKeys - 1) / kKeys;
  for (int kb = 0; kb < nblocks; ++kb) {
    const int key0 = kb * kKeys;
    // K and V block -> ks, vs (f32); keys at or past plen are zeros.
    for (int c = tid; c < kKeys * (D / kVec); c += kThreads) {
      const int j = c / (D / kVec);
      const int d = (c % (D / kVec)) * kVec;
      float kv[kVec], vv[kVec];
      if (key0 + j < plen) {
        const size_t off = (((size_t)r * P + key0 + j) * KVH + h) * D + d;
        Vec<T>::load(pk + off, kv);
        Vec<T>::load(pv + off, vv);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) kv[e] = vv[e] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        ks[j * kStride + d + e] = kv[e];
        vs[j * kStride + d + e] = vv[e];
      }
    }
    __syncthreads();

    // Scores for rows rg*4 + i, keys kg + 16*j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + (rg * 4 + i) * kStride + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(ks + (kg + 16 * j) * kStride + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }

    // Online softmax over this block, rows shared by the 16 lanes of kg.
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float bm = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool valid = key0 + kg + 16 * j < plen;
        s[i][j] = valid ? s[i][j] * sm_scale : kNegInf;
        bm = fmaxf(bm, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, o));
      const float m_new = fmaxf(m[i], bm);
      alpha[i] = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        pT[(kg + 16 * j) * kPStride + rg * 4 + i] = p;
        rs += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * alpha[i] + rs;
      m[i] = m_new;
    }
    __syncthreads();

    // acc = acc * alpha + p . v
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < kNC; ++e) acc[i][e] *= alpha[i];
    for (int j = 0; j < kKeys; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(pT + j * kPStride + rg * 4);
      const float pr[4] = {p.x, p.y, p.z, p.w};
      float v[kNC];
      if constexpr (D >= 64) {
#pragma unroll
        for (int u = 0; u < kNC / 4; ++u) {
          const float4 vv = *reinterpret_cast<const float4*>(vs + j * kStride + 64 * u + kg * 4);
          v[4 * u] = vv.x;
          v[4 * u + 1] = vv.y;
          v[4 * u + 2] = vv.z;
          v[4 * u + 3] = vv.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < kNC; ++e) v[e] = vs[j * kStride + col_of<D>(kg, e)];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < kNC; ++e) acc[i][e] = fmaf(pr[i], v[e], acc[i][e]);
    }
    __syncthreads();  // ks, vs and pT are refilled by the next block
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = tile0 + rg * 4 + i;
    if (qi >= QR) continue;
    const int b = r * n_per + qi / G;
    const int qh = h * G + qi % G;
    const size_t row = (size_t)b * QH + qh;
    const float inv = 1.0f / (l[i] == 0.0f ? 1.0f : l[i]);
#pragma unroll
    for (int e = 0; e < kNC; ++e) out[row * D + col_of<D>(kg, e)] = acc[i][e] * inv;
    if (kg == 0) {
      m_out[row] = m[i];
      l_out[row] = l[i];
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* pk, const void* pv, const int* prompt_lens,
           float* out, float* m, float* l, int B, int QH, int KVH, int R, int P,
           float sm_scale, cudaStream_t stream) {
  const size_t smem =
      ((size_t)(kRows + 2 * kKeys) * (D + 4) + (size_t)kKeys * kPStride) * sizeof(float);
  auto kernel = decode_prefix_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_per = B / R;
  const int QR = n_per * (QH / KVH);
  const dim3 grid(R * KVH, (QR + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk), static_cast<const T*>(pv),
      prompt_lens, out, m, l, QH, KVH, n_per, P, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dim(int D, const void* q, const void* pk, const void* pv,
                 const int* prompt_lens, float* out, float* m, float* l, int B, int QH,
                 int KVH, int R, int P, float sm_scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, pk, pv, prompt_lens, out, m, l, B, QH, KVH, R, P, sm_scale,
                           stream);
    case 64:
      return launch<T, 64>(q, pk, pv, prompt_lens, out, m, l, B, QH, KVH, R, P, sm_scale,
                           stream);
    case 128:
      return launch<T, 128>(q, pk, pv, prompt_lens, out, m, l, B, QH, KVH, R, P, sm_scale,
                            stream);
    case 256:
      return launch<T, 256>(q, pk, pv, prompt_lens, out, m, l, B, QH, KVH, R, P, sm_scale,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point for ctypes. Returns the CUDA status of the launch
// (0 = success).
extern "C" int kllms_decode_prefix_attention(const void* q, const void* prefix_k,
                                             const void* prefix_v, const int* prompt_lens,
                                             float* out, float* m, float* l, int B, int QH,
                                             int KVH, int D, int R, int P, int is_bf16,
                                             float sm_scale, void* stream) {
  if (B <= 0 || QH <= 0 || KVH <= 0 || QH % KVH != 0 || R <= 0 || B % R != 0 || P <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch_dim<__nv_bfloat16>(D, q, prefix_k, prefix_v, prompt_lens, out, m, l, B,
                                       QH, KVH, R, P, sm_scale, s);
  }
  return dispatch_dim<float>(D, q, prefix_k, prefix_v, prompt_lens, out, m, l, B, QH, KVH,
                             R, P, sm_scale, s);
}
