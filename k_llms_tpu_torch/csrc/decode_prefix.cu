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
// Key c of request r is valid iff c < prompt_lens[r]; invalid keys are never
// read and their scores are -inf, so they add an exact 0. The caller merges
// (out, m, l) with the generated tail (models/llama.py, _merge_prefix_tail).
//
// What bounds it on this card: bytes. Each prefix key feeds 4 * D FLOPs per
// query row, about 32 FLOPs per byte at n * G = 32 rows, far below the
// card's ~295 FLOP/byte bf16 balance point: the least time is the valid
// prefix read once. At the main path's shape (one request of n = 8 rows,
// 8 kv heads) one CTA per (request, kv head) puts 8 CTAs on 132 SMs, which
// cannot pull the prefix at the card's rate. So the grid is
// (request x tile of 32 query rows, kv head, key split):
//   * a CTA serves every query row of its tile (query row i is batch row
//     r * n + i / G, query head h * G + i % G, indexed in place), so each
//     prefix key is read once per request and tile;
//   * the request's valid key blocks (64 keys each, ceil(plen / 64) of
//     them) are cut into `splits` contiguous, in-order, near-equal ranges:
//     split z walks blocks [z * nb / splits, (z + 1) * nb / splits). Each CTA
//     computes its own range from prompt_lens on the device, so the launch
//     depends on shapes alone (ops/attention.py::decode_prefix_split_plan
//     picks `splits`, the fewest that put about one CTA on each SM) and
//     needs no host sync;
//   * each CTA writes an f32 (unnormalised out, max in log2 units,
//     denominator) partial per query row; a second kernel,
//     decode_prefix_merge, one CTA per (row, kv head), merges a row's
//     splits in split order, so the result does not depend on the order in
//     which CTAs finish. An empty split (wholly past plen) has max -inf and
//     weighs an exact 0 by an explicit test. The merge is a second launch
//     rather than the last CTA of each (request, kv head): the partials of
//     32 rows x D x splits floats (278 KB at the main shape) would then be
//     read by 8 CTAs, where the merge grid spreads them over B * KVH CTAs.
// K/V blocks stream through a two-stage cp.async ring in their stored dtype;
// keys at or past the range's end are zero-filled, never loaded. Two split
// kernels, chosen by the wrapper (decode_prefix_route):
//   * decode_prefix_tc (bf16, D = 64, 128, 256): S = Q K^T and O += P V on
//     mma.sync.m16n8k16 (bf16 in, f32 accumulated) fed by ldmatrix from
//     bf16 shared memory, never widened to f32; the online softmax in f32
//     registers (log2 units). 32 query rows are two m16 tiles; the 4 warps
//     split the tiles and the head dims of O. Products of bf16 values are
//     exact in f32, so S is the reference's up to summation order. P is f32
//     in the reference; here it is split into two bf16 pieces (P_hi =
//     bf16(P), P_lo = bf16(P - P_hi)), each multiplied into the f32
//     accumulator, which carries P to about 2^-17 of itself: out is held to
//     2e-5 |ref| + 2e-5, which one bf16 rounding of P (2^-9) breaks at the
//     main shape and two pieces hold with a wide margin
//     (tests/test_torch_decode_prefix_split.py). l is summed from the f32 P.
//   * decode_prefix_simt (f32, and bf16 at D = 16): the same split and merge
//     with f32 products on the CUDA cores (TF32 would change f32 results):
//     K/V widened to f32 in shared memory, each of 128 threads holding a
//     4 x 4 block of scores and a 4-row slice of the output accumulator.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using namespace kllms;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 32;  // query rows per CTA
constexpr int kBlock = 64;     // keys per block
constexpr float kNegInf = -3.4028234663852886e38f;  // finfo(float32).min
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* pk;
  const void* pv;
  const int* prompt_lens;
  float* out;
  float* m_out;
  float* l_out;
  float* o_part;   // [splits][B][QH][D] unnormalised outputs
  float* ml_part;  // [splits][B][QH][2] max (log2 units), denominator
  int B, QH, KVH, n_per, P;
  int tiles;   // ceil(n_per * G / kTileRows) query-row tiles per request
  int splits;  // key splits per (request, tile, kv head)
  float scale_log2;  // sm_scale * log2(e)
};

// What one CTA walks: query rows [tile0, tile0 + qrows) of request r for kv
// head h, keys [k_begin, k_end) (whole key blocks but the prompt's last).
struct Work {
  int r, h, z, G, tile0, qrows, k_begin, k_end;
};

__device__ __forceinline__ Work make_work(const Params& p) {
  Work w;
  w.r = blockIdx.x / p.tiles;
  w.h = blockIdx.y;
  w.z = blockIdx.z;
  w.G = p.QH / p.KVH;
  w.tile0 = (blockIdx.x % p.tiles) * kTileRows;
  w.qrows = min(kTileRows, p.n_per * w.G - w.tile0);
  const int plen = min(max(p.prompt_lens[w.r], 0), p.P);
  const int nb = (plen + kBlock - 1) / kBlock;
  // 32-bit arithmetic (the entry point keeps splits * blocks below 2^31):
  // no 64-bit division routine in the range computation.
  const int lo = w.z * nb / p.splits;
  const int hi = (w.z + 1) * nb / p.splits;
  w.k_begin = lo * kBlock;
  w.k_end = min(hi * kBlock, plen);
  return w;
}

// The (batch row, query head) flat index of tile row qr.
__device__ __forceinline__ size_t query_index(const Params& p, const Work& w, int qr) {
  const int i = w.tile0 + qr;
  return (size_t)(w.r * p.n_per + i / w.G) * p.QH + (size_t)w.h * w.G + i % w.G;
}

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

// grid (B, KVH): merges row b's partials for kv head h (query heads h*G ..
// +G) in split order and writes out, m (natural units) and l. Dynamic
// shared memory: G * (splits + 1) floats.
__global__ void __launch_bounds__(kThreads) decode_prefix_merge(Params p, int D) {
  extern __shared__ __align__(16) float scratch[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int G = p.QH / p.KVH;
  const int Z = p.splits;
  const float2* ml = reinterpret_cast<const float2*>(p.ml_part);
  float* w_s = scratch;       // [G][Z] weight of each split
  float* inv_s = w_s + G * Z;  // [G] 1 / denominator
  const size_t q0 = (size_t)blockIdx.x * p.QH + (size_t)blockIdx.y * G;
  const size_t zstride = (size_t)p.B * p.QH;

  for (int gh = warp; gh < G; gh += kWarps) {
    float m = -INFINITY;
    for (int z = lane; z < Z; z += 32) m = fmaxf(m, ml[z * zstride + q0 + gh].x);
    m = warp_max(m);
    float l = 0.f;
    for (int z = lane; z < Z; z += 32) {
      const float2 v = ml[z * zstride + q0 + gh];
      // An empty split (max -inf) weighs an exact 0.
      const float wz = v.x == -INFINITY ? 0.f : exp2f(v.x - m);
      w_s[gh * Z + z] = wz;
      if (wz != 0.f) l = fmaf(wz, v.y, l);
    }
    l = warp_sum(l);
    if (lane == 0) {
      inv_s[gh] = 1.f / (l == 0.f ? 1.f : l);
      p.m_out[q0 + gh] = m == -INFINITY ? kNegInf : m * kLn2;
      p.l_out[q0 + gh] = l;
    }
  }
  __syncthreads();

  // Four head dims per item; the splits' loads are issued ahead of their
  // (ordered) sum.
  constexpr int kUnroll = 8;
  for (int item = tid; item < G * (D / 4); item += kThreads) {
    const int gh = item / (D / 4);
    const int d = (item % (D / 4)) * 4;
    const float4* op = reinterpret_cast<const float4*>(p.o_part + (q0 + gh) * D + d);
    const size_t zs = zstride * D / 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z0 = 0; z0 < Z; z0 += kUnroll) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        v[u] = z0 + u < Z ? __ldcg(op + (z0 + u) * zs) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float wz = z0 + u < Z ? w_s[gh * Z + z0 + u] : 0.f;
        if (wz != 0.f) {
          acc.x = fmaf(wz, v[u].x, acc.x);
          acc.y = fmaf(wz, v[u].y, acc.y);
          acc.z = fmaf(wz, v[u].z, acc.z);
          acc.w = fmaf(wz, v[u].w, acc.w);
        }
      }
    }
    const float inv = inv_s[gh];
    *reinterpret_cast<float4*>(p.out + (q0 + gh) * D + d) =
        make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
  }
}

// --- bf16 on the tensor cores -------------------------------------------------

template <int D, int MT>
struct TcTile {
  static constexpr int kStride = D + 8;  // bf16 per shared row: the 16-byte pad puts
                                         // the 8 rows an ldmatrix reads on distinct banks
  static constexpr int kRows = 16 * MT;  // query rows, padded to m16 tiles
  static constexpr size_t kQBytes = (size_t)kRows * kStride * 2;
  static constexpr size_t kSmemBytes =
      kQBytes + (size_t)2 /*stages*/ * 2 /*K, V*/ * kBlock * kStride * 2;
};

// grid (R * tiles, KVH, splits). Warp w computes S for m16 tile w % MT (all
// 64 keys of a block) and O for head dims (w / MT) * D*MT/4 ..
template <int D, int MT>
__global__ void __launch_bounds__(kThreads) decode_prefix_tc(Params p) {
  using Tile = TcTile<D, MT>;
  constexpr int ST = Tile::kStride;
  constexpr int CH = D / 8;       // 16-byte chunks per key row
  constexpr int KD = D / 16;      // k-steps of S
  constexpr int NT = kBlock / 8;  // n8 tiles of S
  constexpr int DW = D * MT / 4;  // head dims of O per warp
  constexpr int DT = DW / 8;      // n8 tiles of O per warp
  static_assert(DW >= 16, "each warp needs whole 16-column steps of O");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kRows][ST]
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + Tile::kQBytes);

  const Work w = make_work(p);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const __nv_bfloat16* pk = static_cast<const __nv_bfloat16*>(p.pk);
  const __nv_bfloat16* pv = static_cast<const __nv_bfloat16*>(p.pv);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);

  // Query rows; padding rows are zero-filled and never written out.
  for (int c = tid; c < Tile::kRows * CH; c += kThreads) {
    const int qr = c / CH;
    const int ch = c % CH;
    const bool ok = qr < w.qrows;
    const size_t qi = ok ? query_index(p, w, qr) : 0;
    cp_async_16(q_s + qr * ST + ch * 8, q + qi * D + ch * 8, ok ? 16 : 0);
  }
  const int n_blocks = (w.k_end - w.k_begin + kBlock - 1) / kBlock;
  const size_t key_stride = (size_t)p.KVH * D;
  const size_t head0 = ((size_t)w.r * p.P * p.KVH + w.h) * D;
  auto load_block = [&](int blk, int stage) {
    const int k0 = w.k_begin + blk * kBlock;
    __nv_bfloat16* ks = kv_s + stage * 2 * kBlock * ST;
    __nv_bfloat16* vs = ks + kBlock * ST;
    for (int c = tid; c < kBlock * CH; c += kThreads) {
      const int rr = c / CH;
      const int ch = c % CH;
      const bool ok = k0 + rr < w.k_end;
      const size_t src = ok ? head0 + (size_t)(k0 + rr) * key_stride + ch * 8 : 0;
      cp_async_16(ks + rr * ST + ch * 8, pk + src, ok ? 16 : 0);
      cp_async_16(vs + rr * ST + ch * 8, pv + src, ok ? 16 : 0);
    }
  };
  if (n_blocks > 0) load_block(0, 0);
  cp_async_commit();

  const int mt = warp % MT;
  const int d0 = (warp / MT) * DW;  // the warp's first head dim of O
  const int qr0 = mt * 16 + g;      // the lane's query rows qr0 and qr0 + 8
  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max (log2 units)
  float l[2] = {0.f, 0.f};              // this lane's share of the running sums
  const __nv_bfloat16* q_frag = q_s + (mt * 16 + (lane & 15)) * ST + (lane >> 4) * 8;

  for (int it = 0; it < n_blocks; ++it) {
    __syncthreads();  // every warp is done with the stage the next copy refills
    if (it + 1 < n_blocks) load_block(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // block `it` (and at it == 0 the query rows) is in shared memory
    const __nv_bfloat16* ks = kv_s + (it & 1) * 2 * kBlock * ST;
    const __nv_bfloat16* vs = ks + kBlock * ST;
    const int k0 = w.k_begin + it * kBlock;

    // S = Q K^T for the tile's 16 rows x 64 keys.
    float s[NT][4];  // started by the first k-step
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t qa[4];
      ldmatrix_x4(qa, q_frag + kd * 16);
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

    // Scale and mask in f32 registers, log2 units.
    float blk_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = k0 + nt * 8 + 2 * t + (e & 1) < w.k_end;
        const float x = valid ? s[nt][e] * p.scale_log2 : -INFINITY;
        s[nt][e] = x;
        blk_max[e >> 1] = fmaxf(blk_max[e >> 1], x);
      }
    }
    float m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // The 4 lanes of a row are adjacent: a butterfly gives each the max.
      blk_max[i] = fmaxf(blk_max[i], __shfl_xor_sync(0xffffffffu, blk_max[i], 1));
      blk_max[i] = fmaxf(blk_max[i], __shfl_xor_sync(0xffffffffu, blk_max[i], 2));
      const float m_new = fmaxf(m[i], blk_max[i]);
      // A row with no valid key yet keeps m = -inf; exponents are then
      // taken against 0 so that masked scores give exp2(-inf) = 0, not NaN.
      m_use[i] = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[i] - m_use[i]);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        o[dt][2 * i] *= alpha;
        o[dt][2 * i + 1] *= alpha;
      }
    }

    // O += P V over 16-key steps. The score fragment of keys 16kk .. +15 is
    // the A fragment of the step; P = P_hi + P_lo, both bf16, both
    // multiplied into the f32 accumulator.
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk) {
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // j: (row g, keys 2t..), (row g+8, 2t..), (row g, 8+2t..), (row g+8, 8+2t..)
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
      for (int dq = 0; dq < DT / 2; ++dq) {
        // Keys 16kk .. +15 at head dims d0 + dq*16 .. +15, transposed: two B fragments.
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ST + d0 +
                                  dq * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dq], ph, vb[0], vb[1]);
        mma_bf16(o[2 * dq + 1], ph, vb[2], vb[3]);
        mma_bf16(o[2 * dq], pl, vb[0], vb[1]);
        mma_bf16(o[2 * dq + 1], pl, vb[2], vb[3]);
      }
    }
  }
  cp_async_wait<0>();

  // Partials of the lane's rows: unnormalised O, and (from the warps of the
  // first head-dim slice) the max and the denominator.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int qr = qr0 + 8 * i;
    if (qr >= w.qrows) continue;
    const size_t slot = (size_t)w.z * p.B * p.QH + query_index(p, w, qr);
    float* op = p.o_part + slot * D + d0 + 2 * t;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<float2*>(op + dt * 8) = make_float2(o[dt][2 * i], o[dt][2 * i + 1]);
    }
    if (d0 == 0 && t == 0) reinterpret_cast<float2*>(p.ml_part)[slot] = make_float2(m[i], l[i]);
  }
}

// --- f32 (and bf16 at D = 16) on the CUDA cores ------------------------------

constexpr int kPStride = kTileRows + 4;

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

template <int D>
constexpr size_t simt_smem_bytes() {
  return ((size_t)(kTileRows + 2 * kBlock) * (D + 4) + (size_t)kBlock * kPStride) * sizeof(float);
}

// grid (R * tiles, KVH, splits). Thread tid owns rows rg*4 .. +4 of the tile
// (rg = tid / 16) and keys kg + 16*j of a block, columns col_of(kg, e)
// (kg = tid % 16).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) decode_prefix_simt(Params p) {
  constexpr int kStride = D + 4;
  constexpr int kNC = D / 16;  // output columns per thread
  constexpr int kVec = Vec<T>::kN;
  extern __shared__ float smem[];
  float* qs = smem;                      // [kTileRows][kStride]
  float* ks = qs + kTileRows * kStride;  // [kBlock][kStride]
  float* vs = ks + kBlock * kStride;     // [kBlock][kStride]
  float* pT = vs + kBlock * kStride;     // [kBlock][kPStride]

  const Work w = make_work(p);
  const int tid = threadIdx.x;
  const int rg = tid / 16;
  const int kg = tid % 16;
  const T* q = static_cast<const T*>(p.q);
  const T* pk = static_cast<const T*>(p.pk);
  const T* pv = static_cast<const T*>(p.pv);

  // Query tile -> qs (f32); rows past the tile's end are zeros.
  for (int c = tid; c < kTileRows * (D / kVec); c += kThreads) {
    const int i = c / (D / kVec);
    const int d = (c % (D / kVec)) * kVec;
    float vals[kVec];
    if (i < w.qrows) {
      Vec<T>::load(q + query_index(p, w, i) * D + d, vals);
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
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < kNC; ++e) acc[i][e] = 0.0f;
  }

  for (int key0 = w.k_begin; key0 < w.k_end; key0 += kBlock) {
    // K and V block -> ks, vs (f32); keys at or past the range's end are zeros.
    for (int c = tid; c < kBlock * (D / kVec); c += kThreads) {
      const int j = c / (D / kVec);
      const int d = (c % (D / kVec)) * kVec;
      float kv[kVec], vv[kVec];
      if (key0 + j < w.k_end) {
        const size_t off = (((size_t)w.r * p.P + key0 + j) * p.KVH + w.h) * D + d;
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

    // Online softmax over this block (log2 units), rows shared by the 16
    // lanes of kg.
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float bm = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool valid = key0 + kg + 16 * j < w.k_end;
        s[i][j] = valid ? s[i][j] * p.scale_log2 : -INFINITY;
        bm = fmaxf(bm, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, o));
      const float m_new = fmaxf(m[i], bm);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = exp2f(m[i] - m_use);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pr = exp2f(s[i][j] - m_use);
        pT[(kg + 16 * j) * kPStride + rg * 4 + i] = pr;
        rs += pr;
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
    for (int j = 0; j < kBlock; ++j) {
      const float4 pr4 = *reinterpret_cast<const float4*>(pT + j * kPStride + rg * 4);
      const float pr[4] = {pr4.x, pr4.y, pr4.z, pr4.w};
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
    const int qr = rg * 4 + i;
    if (qr >= w.qrows) continue;
    const size_t slot = (size_t)w.z * p.B * p.QH + query_index(p, w, qr);
#pragma unroll
    for (int e = 0; e < kNC; ++e) p.o_part[slot * D + col_of<D>(kg, e)] = acc[i][e];
    if (kg == 0) reinterpret_cast<float2*>(p.ml_part)[slot] = make_float2(m[i], l[i]);
  }
}

// The split kernel, then the merge.
template <typename K>
int launch_pair(K split_kernel, size_t smem, const Params& p, int R, int D,
                cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  split_kernel<<<dim3(R * p.tiles, p.KVH, p.splits), kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t merge_smem = (size_t)(p.QH / p.KVH) * (p.splits + 1) * sizeof(float);
  err = cudaFuncSetAttribute(decode_prefix_merge, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)merge_smem);
  if (err != cudaSuccess) return (int)err;
  decode_prefix_merge<<<dim3(p.B, p.KVH), kThreads, merge_smem, stream>>>(p, D);
  return (int)cudaGetLastError();
}

template <int D>
int launch_tc(const Params& p, int R, cudaStream_t stream) {
  if (p.n_per * (p.QH / p.KVH) <= 16) {
    return launch_pair(decode_prefix_tc<D, 1>, TcTile<D, 1>::kSmemBytes, p, R, D, stream);
  }
  return launch_pair(decode_prefix_tc<D, 2>, TcTile<D, 2>::kSmemBytes, p, R, D, stream);
}

template <typename T, int D>
int launch_simt(const Params& p, int R, cudaStream_t stream) {
  return launch_pair(decode_prefix_simt<T, D>, simt_smem_bytes<D>(), p, R, D, stream);
}

}  // namespace

// Plain C entry point for ctypes. `route` is the split kernel the wrapper
// chose (0 the CUDA-core kernel, 1 the tensor-core kernel, bf16 only);
// `tiles` query-row tiles per request and `splits` key splits follow
// ops/attention.py::decode_prefix_split_plan. `o_part` / `ml_part` are f32
// scratch of splits * B * QH * D and splits * B * QH * 2 floats. Returns the
// CUDA status of the launches (0 = success).
extern "C" int kllms_decode_prefix_attention(const void* q, const void* prefix_k,
                                             const void* prefix_v, const int* prompt_lens,
                                             float* out, float* m, float* l, float* o_part,
                                             float* ml_part, int B, int QH, int KVH, int D,
                                             int R, int P, int is_bf16, int route, int tiles,
                                             int splits, float sm_scale, void* stream) {
  if (B <= 0 || QH <= 0 || KVH <= 0 || QH % KVH != 0 || R <= 0 || B % R != 0 || P <= 0 ||
      tiles != ((B / R) * (QH / KVH) + kTileRows - 1) / kTileRows || R * tiles > 65535 ||
      splits <= 0 || splits > 65535 ||
      (long long)(splits + 1) * ((P + kBlock - 1) / kBlock) >= (1LL << 31) ||
      (route == 1 && !is_bf16) || route < 0 || route > 1) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.q = q;
  p.pk = prefix_k;
  p.pv = prefix_v;
  p.prompt_lens = prompt_lens;
  p.out = out;
  p.m_out = m;
  p.l_out = l;
  p.o_part = o_part;
  p.ml_part = ml_part;
  p.B = B;
  p.QH = QH;
  p.KVH = KVH;
  p.n_per = B / R;
  p.P = P;
  p.tiles = tiles;
  p.splits = splits;
  p.scale_log2 = sm_scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    switch (D) {
      case 64: return launch_tc<64>(p, R, s);
      case 128: return launch_tc<128>(p, R, s);
      case 256: return launch_tc<256>(p, R, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (is_bf16) {
    if (D == 16) return launch_simt<__nv_bfloat16, 16>(p, R, s);
    return (int)cudaErrorInvalidValue;
  }
  switch (D) {
    case 16: return launch_simt<float, 16>(p, R, s);
    case 64: return launch_simt<float, 64>(p, R, s);
    case 128: return launch_simt<float, 128>(p, R, s);
    case 256: return launch_simt<float, 256>(p, R, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
