// Fused paged-decode attention for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel
// k_llms_tpu/ops/paged_attention.py::_paged_decode_kernel (entry
// paged_decode_attention_pallas). Same contract, one query position per row:
//   q [B, QH, D]; pool_k/pool_v one layer's flat pool [pages * ps, KVH, D];
//   prefix_pages [R, NP] shared by the B / R rows of each request
//   (request-major rows: row b reads table row b / (B / R));
//   gen_pages [B, NG]; gen_phase [B] = in-page offset of gen position 0;
//   new_k/new_v [B, KVH, D] = this step's column, not yet in the pool;
//   prompt_lens / gen_lens [B]; out [B, QH, D] f32.
// Page j < NP holds prefix positions j*ps + o; page j >= NP holds gen
// positions (j - NP)*ps + o - phase. A slot is valid iff 0 <= pos < limit
// (limit = prompt_len for prefix pages, gen_len for gen pages, so the current
// token is excluded); every other slot (padding, the trash page, the phase
// lead-in) is masked before the max and contributes an exact 0. The fresh
// column is folded in last. Query head h*G + g reads kv head h.
//
// What bounds it on this card: bytes. Decode attention does ~2 FLOPs per
// K/V byte, far below the card's ~295 FLOP/byte balance point. This first
// version runs one CTA per (row, kv head), so the prefix pages a request's
// rows share are read once per row, not once per request: n times the
// byte bound at n samples. Reading each shared page once for all of a
// request's rows (and splitting long page walks across CTAs) is the first
// redesign target. Within that, the design keeps traffic to one read:
//   * the CTA loads its own page ids from the tables (no scalar prefetch on
//     this card) and skips pages with no valid slot;
//   * one [ps, D] K page and V page at a time are staged in shared memory as
//     f32 with 16-byte loads, rows padded to D + 1 floats so that a warp
//     reading one dimension of 32 slots hits 32 banks;
//   * the G query heads of the kv head share every page read; scores and the
//     online-softmax state stay in shared memory, the output accumulator in
//     registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPairsPerThread = 8;  // G * D <= 1024
constexpr float kNegInf = -3.4028234663852886e38f;  // finfo(float32).min

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                    const T* __restrict__ pool_v, const int* __restrict__ prefix_pages,
                    const int* __restrict__ gen_pages, const int* __restrict__ gen_phase,
                    const T* __restrict__ new_k, const T* __restrict__ new_v,
                    const int* __restrict__ prompt_lens, const int* __restrict__ gen_lens,
                    float* __restrict__ out, int QH, int KVH, int n_per, int NP,
                    int NG, int ps, int num_pages, float sm_scale) {
  constexpr int DS = D + 1;  // padded shared row stride
  constexpr int kVec = VecLoad<T>::kVec;
  static_assert(D % kVec == 0, "unsupported head dim");

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int G = QH / KVH;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  extern __shared__ float smem[];
  float* k_s = smem;            // [ps][DS]
  float* v_s = k_s + ps * DS;   // [ps][DS]
  float* q_s = v_s + ps * DS;   // [G][D]
  float* p_s = q_s + G * D;     // [G][ps] scores, then probabilities
  float* m_s = p_s + G * ps;    // [G] running max
  float* l_s = m_s + G;         // [G] running denominator
  float* a_s = l_s + G;         // [G] rescale factor of the current page

  const int r = b / n_per;
  const int plen = prompt_lens[b];
  const int glen = gen_lens[b];
  const int phase = gen_phase[b];
  const size_t slot_stride = (size_t)KVH * D;  // pool elements per slot

  const T* q_row = q + ((size_t)b * QH + (size_t)h * G) * D;
  for (int i = tid; i < G * D; i += kThreads) q_s[i] = to_f32(q_row[i]);
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  float acc[kMaxPairsPerThread];
#pragma unroll
  for (int i = 0; i < kMaxPairsPerThread; ++i) acc[i] = 0.f;
  // A page id outside the pool (a corrupt or stale table) is never read:
  // the row's output becomes NaN, which the engine's quarantine of
  // non-finite rows catches.
  bool bad_page = false;

  for (int j = 0; j < NP + NG; ++j) {
    const bool is_prefix = j < NP;
    const int base = is_prefix ? j * ps : (j - NP) * ps - phase;  // pos of slot 0
    const int limit = is_prefix ? plen : glen;
    if (base + ps <= 0 || base >= limit) continue;  // no valid slot: CTA-uniform
    const int page = is_prefix ? prefix_pages[(size_t)r * NP + j]
                               : gen_pages[(size_t)b * NG + (j - NP)];
    if (page < 0 || page >= num_pages) {  // CTA-uniform
      bad_page = true;
      continue;
    }
    const T* kp = pool_k + (size_t)page * ps * slot_stride + (size_t)h * D;
    const T* vp = pool_v + (size_t)page * ps * slot_stride + (size_t)h * D;

    __syncthreads();  // every thread is done with the previous page
    for (int idx = tid * kVec; idx < ps * D; idx += kThreads * kVec) {
      const int o = idx / D;
      const int d = idx % D;
      float kv[kVec];
      float vv[kVec];
      VecLoad<T>::load(kp + (size_t)o * slot_stride + d, kv);
      VecLoad<T>::load(vp + (size_t)o * slot_stride + d, vv);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        k_s[o * DS + d + e] = kv[e];
        v_s[o * DS + d + e] = vv[e];
      }
    }
    __syncthreads();

    // Scores of the G query heads against the page's slots; masked slots get
    // -inf, which no max selects and exp() turns into an exact 0.
    for (int idx = tid; idx < G * ps; idx += kThreads) {
      const int g = idx / ps;
      const int o = idx % ps;
      const int p = base + o;
      float sc = -INFINITY;
      if (p >= 0 && p < limit) {
        const float* kr = k_s + o * DS;
        const float* qg = q_s + g * D;
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot = fmaf(qg[d], kr[d], dot);
        sc = dot * sm_scale;
      }
      p_s[idx] = sc;
    }
    __syncthreads();

    // Online-softmax update, one warp per query head.
    for (int g = warp; g < G; g += kWarps) {
      float mx = -INFINITY;
      for (int o = lane; o < ps; o += 32) mx = fmaxf(mx, p_s[g * ps + o]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int o = lane; o < ps; o += 32) {
        const float pr = expf(p_s[g * ps + o] - m_new);
        p_s[g * ps + o] = pr;
        sum += pr;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc[g, d] = acc * alpha + sum_o p[g, o] * v[o, d]
#pragma unroll
    for (int i = 0; i < kMaxPairsPerThread; ++i) {
      const int pair = tid + i * kThreads;
      if (pair < G * D) {
        const int g = pair / D;
        const int d = pair % D;
        const float* pg = p_s + g * ps;
        float a = acc[i] * a_s[g];
        for (int o = 0; o < ps; ++o) a = fmaf(pg[o], v_s[o * DS + d], a);
        acc[i] = a;
      }
    }
  }

  // Finalize: fold in the fresh column (always valid), then normalise.
  __syncthreads();
  const size_t col = ((size_t)b * KVH + h) * D;
  for (int d = tid; d < D; d += kThreads) {
    k_s[d] = to_f32(new_k[col + d]);
    v_s[d] = to_f32(new_v[col + d]);
  }
  __syncthreads();
  for (int g = warp; g < G; g += kWarps) {
    float dot = 0.f;
    for (int d = lane; d < D; d += 32) dot = fmaf(q_s[g * D + d], k_s[d], dot);
    dot = warp_sum(dot);
    if (lane == 0) {
      const float sc = dot * sm_scale;
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, sc);
      const float alpha = expf(m_old - m_new);
      const float pr = expf(sc - m_new);
      a_s[g] = alpha;
      p_s[g] = pr;
      l_s[g] = l_s[g] * alpha + pr;
    }
  }
  __syncthreads();
  float* o_row = out + ((size_t)b * QH + (size_t)h * G) * D;
#pragma unroll
  for (int i = 0; i < kMaxPairsPerThread; ++i) {
    const int pair = tid + i * kThreads;
    if (pair < G * D) {
      const int g = pair / D;
      const int d = pair % D;
      const float a = acc[i] * a_s[g] + p_s[g] * v_s[d];
      const float l = l_s[g];
      o_row[pair] = bad_page ? NAN : a / (l == 0.f ? 1.f : l);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* pool_k, const void* pool_v,
           const int* prefix_pages, const int* gen_pages, const int* gen_phase,
           const void* new_k, const void* new_v, const int* prompt_lens,
           const int* gen_lens, float* out, int B, int QH, int KVH, int R, int NP,
           int NG, int ps, int num_pages, float sm_scale, cudaStream_t stream) {
  const int G = QH / KVH;
  const size_t smem =
      (2 * (size_t)ps * (D + 1) + (size_t)G * D + (size_t)G * ps + 3 * (size_t)G) *
      sizeof(float);
  auto kernel = paged_decode_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B, KVH);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool_k),
      static_cast<const T*>(pool_v), prefix_pages, gen_pages, gen_phase,
      static_cast<const T*>(new_k), static_cast<const T*>(new_v), prompt_lens,
      gen_lens, out, QH, KVH, B / R, NP, NG, ps, num_pages, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dim(int D, const void* q, const void* pool_k, const void* pool_v,
                 const int* prefix_pages, const int* gen_pages, const int* gen_phase,
                 const void* new_k, const void* new_v, const int* prompt_lens,
                 const int* gen_lens, float* out, int B, int QH, int KVH, int R,
                 int NP, int NG, int ps, int num_pages, float sm_scale,
                 cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, pool_k, pool_v, prefix_pages, gen_pages, gen_phase, new_k,
                           new_v, prompt_lens, gen_lens, out, B, QH, KVH, R, NP, NG, ps,
                           num_pages, sm_scale, stream);
    case 64:
      return launch<T, 64>(q, pool_k, pool_v, prefix_pages, gen_pages, gen_phase, new_k,
                           new_v, prompt_lens, gen_lens, out, B, QH, KVH, R, NP, NG, ps,
                           num_pages, sm_scale, stream);
    case 128:
      return launch<T, 128>(q, pool_k, pool_v, prefix_pages, gen_pages, gen_phase, new_k,
                            new_v, prompt_lens, gen_lens, out, B, QH, KVH, R, NP, NG, ps,
                            num_pages, sm_scale, stream);
    case 256:
      return launch<T, 256>(q, pool_k, pool_v, prefix_pages, gen_pages, gen_phase, new_k,
                            new_v, prompt_lens, gen_lens, out, B, QH, KVH, R, NP, NG, ps,
                            num_pages, sm_scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point for ctypes. Returns the CUDA status of the launch
// (0 = success).
extern "C" int kllms_paged_decode_attention(
    const void* q, const void* pool_k, const void* pool_v, const int* prefix_pages,
    const int* gen_pages, const int* gen_phase, const void* new_k, const void* new_v,
    const int* prompt_lens, const int* gen_lens, float* out, int B, int QH, int KVH,
    int D, int R, int NP, int NG, int page_size, int num_pages, int is_bf16,
    float sm_scale, void* stream) {
  if (B <= 0 || QH <= 0 || KVH <= 0 || QH % KVH != 0 || R <= 0 || B % R != 0 ||
      page_size <= 0 || num_pages <= 0 || (QH / KVH) * D > kThreads * kMaxPairsPerThread) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch_dim<__nv_bfloat16>(D, q, pool_k, pool_v, prefix_pages, gen_pages,
                                       gen_phase, new_k, new_v, prompt_lens, gen_lens,
                                       out, B, QH, KVH, R, NP, NG, page_size,
                                       num_pages, sm_scale, s);
  }
  return dispatch_dim<float>(D, q, pool_k, pool_v, prefix_pages, gen_pages, gen_phase,
                             new_k, new_v, prompt_lens, gen_lens, out, B, QH, KVH, R,
                             NP, NG, page_size, num_pages, sm_scale, s);
}
