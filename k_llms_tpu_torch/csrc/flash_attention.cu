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
// D = 128) attention is arithmetic-bound (about 2*S FLOPs per byte read).
// This first version computes in f32 on the CUDA cores, not on the tensor
// cores, so it sits far below the bf16 tensor-core bound; wgmma, TMA and warp
// specialisation are later work. The design keeps the [Sq, Sk] score matrix
// out of device memory, as the Pallas kernel does:
//   * one CTA per (64-row query block, query head, batch row); 4 threads per
//     query row, each owning every 4th head dimension (bank-conflict free
//     reads of the shared tiles, a 2-step shuffle reduction per score);
//   * K/V tiles of 32 keys staged in shared memory as f32, loaded with
//     16-byte vector loads;
//   * tiles wholly above the causal diagonal, past the key length or below
//     the window are never loaded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
  auto kernel = flash_attention_kernel<T, D>;
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
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, out, key_lengths, B, QH, KVH, Sq, Sk, sm_scale,
                           causal, softcap, window, q_offset, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, key_lengths, B, QH, KVH, Sq, Sk, sm_scale,
                           causal, softcap, window, q_offset, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, key_lengths, B, QH, KVH, Sq, Sk, sm_scale,
                            causal, softcap, window, q_offset, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, key_lengths, B, QH, KVH, Sq, Sk, sm_scale,
                            causal, softcap, window, q_offset, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point for ctypes. Returns the CUDA status of the launch
// (0 = success). softcap <= 0 disables the softcap.
extern "C" int kllms_flash_attention(const void* q, const void* k, const void* v,
                                     void* out, const int* key_lengths, int B,
                                     int QH, int KVH, int Sq, int Sk, int D,
                                     int is_bf16, float sm_scale, int causal,
                                     float softcap, int window, int q_offset,
                                     void* stream) {
  if (B <= 0 || QH <= 0 || KVH <= 0 || QH % KVH != 0 || Sq <= 0 || Sk <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch_dim<__nv_bfloat16>(D, q, k, v, out, key_lengths, B, QH, KVH, Sq,
                                       Sk, sm_scale, causal, softcap, window,
                                       q_offset, s);
  }
  return dispatch_dim<float>(D, q, k, v, out, key_lengths, B, QH, KVH, Sq, Sk,
                             sm_scale, causal, softcap, window, q_offset, s);
}
