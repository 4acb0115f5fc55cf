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
// column is folded in last. Query head h*G + g reads kv head h. A page id
// outside the pool is never read: the rows that would read a valid slot of
// it come out NaN (the engine quarantines non-finite rows).
//
// What bounds it on this card: bytes. Decode attention does ~2 FLOPs per
// K/V byte, far below the card's ~295 FLOP/byte balance point; the bound
// is each request's prefix KV read once plus each row's own generated KV.
// At the main path's shape (one request of n = 8 rows, 8 kv heads) a CTA
// per (row, kv head) would read the shared prefix n times with 64 CTAs on
// 132 SMs. So the grid is (request x row chunk, kv head, key split):
//   * a CTA serves every query row of its request's chunk for one kv head
//     (n * G = 32 rows at n = 8, G = 4), so each shared prefix page is read
//     once per request;
//   * the request's valid prefix pages are cut into `splits` contiguous
//     ranges (ops/paged_attention.py::paged_split_plan picks the count so
//     that about one CTA per SM walks the prefix; split s takes pages
//     [s*P/splits, (s+1)*P/splits) of the P pages with a valid slot), and
//     each row's own generated pages are one more split of that row alone;
//   * each CTA writes an f32 (unnormalised out, max, denominator) partial
//     per query row; a second kernel, paged_decode_merge, one CTA per
//     (row, kv head), merges a row's splits in split order and folds in
//     the fresh column (a merge by the last CTA of the same launch would
//     run on one CTA per kv head, all of a request's rows in turn). A split with
//     no valid slot has max -inf and adds an exact 0; a split that met a
//     bad page marks the denominator NaN, and the merge writes NaN for that
//     row whatever the other maxima are.
// K/V blocks of 64 slots stream through a two-stage cp.async ring in their
// stored dtype; slots that no row may read are zero-filled, never loaded.
// Two kernels, chosen by the wrapper (paged_route):
//   * paged_decode_tc (bf16, D = 64, 128, 256): S = Q K^T and O += P V on
//     mma.sync.m16n8k16 (bf16 in, f32 accumulated) fed by ldmatrix, the
//     online softmax in f32 registers (log2 units). The query rows form one
//     or two m16 tiles; the 4 warps split the tiles and the head dims of O.
//     Products of bf16 values are exact in f32, so S is the reference's up
//     to summation order. P is f32 in the reference; here it is split into
//     three bf16 pieces (P_hi = bf16(P), P_mid = bf16(P - P_hi), P_lo =
//     bf16(P - P_hi - P_mid)), each multiplied into the f32 accumulator,
//     which carries P to about 2^-24 of itself: the output is held to 1e-5
//     absolute, which one bf16 rounding of P (2^-9) breaks and two pieces
//     (2^-17) hold with half the margin (tests/test_torch_paged_split.py).
//   * paged_decode_simt (f32 pools, and bf16 at D = 16): the same split and
//     merge with f32 products on the CUDA cores (TF32 would change f32
//     results), K/V blocks of 32 slots.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using namespace kllms;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPairsPerThread = 8;  // simt: query rows x D <= 1024
constexpr int kMaxChunkRows = 32;      // rows of a request one CTA serves
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* pool_k;
  const void* pool_v;
  const int* prefix_pages;
  const int* gen_pages;
  const int* gen_phase;
  const void* new_k;
  const void* new_v;
  const int* prompt_lens;
  const int* gen_lens;
  float* out;
  float* o_part;   // [splits + 1][B][QH][D] unnormalised outputs
  float* ml_part;  // [splits + 1][B][QH][2] max (log2 units), denominator
  int B, QH, KVH, n_per, NP, NG, ps, num_pages;
  int rpc;     // rows of a request per CTA
  int chunks;  // ceil(n_per / rpc)
  int splits;  // prefix splits
  float scale_log2;  // sm_scale * log2(e)
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

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

// What one CTA walks: rows [row_lo, row_lo + nrows) of one request, for kv
// head h, over slots [t_begin, t_end) of one table row (a prefix split, or
// one row's generated pages). Slot t holds position t - phase.
struct Work {
  int h, r, row_lo, nrows, zi, phase, t_begin, t_end, max_lim;
  bool gen;
  const int* table;
};

// Sets up `w` and the per-row limits and bad-page flags in shared memory.
// Returns false (CTA-uniform) for a generated-pages split past a ragged
// chunk's last row, which has no work and takes no part in the merge.
__device__ bool setup_work(const Params& p, Work& w, int* lim_s, int* bad_s) {
  const int tid = threadIdx.x;
  w.h = blockIdx.y;
  w.r = blockIdx.x / p.chunks;
  const int c = blockIdx.x % p.chunks;
  const int z = blockIdx.z;
  const int first = w.r * p.n_per + c * p.rpc;
  const int chunk_rows = min(p.rpc, p.n_per - c * p.rpc);
  w.gen = z >= p.splits;
  if (w.gen && z - p.splits >= chunk_rows) return false;
  w.row_lo = w.gen ? first + (z - p.splits) : first;
  w.nrows = w.gen ? 1 : chunk_rows;
  w.zi = w.gen ? p.splits : z;
  w.phase = w.gen ? p.gen_phase[w.row_lo] : 0;
  if (tid < w.nrows) {
    const int b = w.row_lo + tid;
    lim_s[tid] = w.gen ? p.gen_lens[b] : p.prompt_lens[b];
    bad_s[tid] = 0;
  }
  __syncthreads();
  int max_lim = 0;
  for (int i = 0; i < w.nrows; ++i) max_lim = max(max_lim, lim_s[i]);
  w.max_lim = max_lim;
  int jlo, jhi;
  if (w.gen) {
    jlo = 0;
    jhi = max_lim > 0 ? min(p.NG, (w.phase + max_lim + p.ps - 1) / p.ps) : 0;
    w.table = p.gen_pages + (size_t)w.row_lo * p.NG;
  } else {
    const int pages = min(p.NP, (max_lim + p.ps - 1) / p.ps);
    jlo = (int)((long long)z * pages / p.splits);
    jhi = (int)((long long)(z + 1) * pages / p.splits);
    w.table = p.prefix_pages + (size_t)w.r * p.NP;
  }
  w.t_begin = jlo * p.ps;
  w.t_end = jhi * p.ps;
  // A page id outside the pool poisons the rows that have a valid slot in it.
  for (int j = jlo + tid; j < jhi; j += kThreads) {
    const int page = w.table[j];
    if (page < 0 || page >= p.num_pages) {
      const int base = j * p.ps - w.phase;
      for (int i = 0; i < w.nrows; ++i) {
        if (base < lim_s[i] && base + p.ps > 0) bad_s[i] = 1;
      }
    }
  }
  __syncthreads();
  return true;
}

// The pool offset (in elements) of slot t's head-h row, or -1 when no row
// of the CTA may read the slot (past the range, a bad page id, a position
// outside [0, max_lim)). `pos` gets the slot's position.
__device__ __forceinline__ long long slot_offset(const Params& p, const Work& w, int t, int D,
                                                 int& pos) {
  pos = -1;
  if (t >= w.t_end) return -1;
  const int j = t / p.ps;
  const int page = w.table[j];
  const int ps_pos = t - w.phase;
  if (page < 0 || page >= p.num_pages || ps_pos < 0 || ps_pos >= w.max_lim) return -1;
  pos = ps_pos;
  return (((long long)page * p.ps + (t - j * p.ps)) * p.KVH + w.h) * D;
}

// grid (B, KVH): merges row b's partials for kv head h (query heads h*G ..
// +G): the splits in order, then the fresh column. Dynamic shared memory:
// G * (splits + 4) floats.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) paged_decode_merge(Params p) {
  extern __shared__ __align__(16) float scratch[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int G = p.QH / p.KVH;
  const int Z = p.splits + 1;
  const T* q = static_cast<const T*>(p.q);
  const T* new_k = static_cast<const T*>(p.new_k);
  const T* new_v = static_cast<const T*>(p.new_v);
  const float2* ml = reinterpret_cast<const float2*>(p.ml_part);
  float* w_s = scratch;       // [G][Z] weight of each split
  float* co_s = w_s + G * Z;  // [G] coefficient of the merged accumulator
  float* cn_s = co_s + G;     // [G] coefficient of the fresh column
  float* bad_s = cn_s + G;    // [G] 1 for a row that met a bad page
  const size_t col = ((size_t)b * p.KVH + h) * D;
  const size_t q0 = (size_t)b * p.QH + (size_t)h * G;  // the first query head's row
  const size_t zstride = (size_t)p.B * p.QH;

  for (int gh = warp; gh < G; gh += kWarps) {
    float dot = 0.f;
    for (int d = lane; d < D; d += 32) dot = fmaf(to_f32(q[(q0 + gh) * D + d]), to_f32(new_k[col + d]), dot);
    dot = warp_sum(dot);
    float m = -INFINITY;
    bool bad = false;
    for (int z = lane; z < Z; z += 32) {
      const float2 v = ml[z * zstride + q0 + gh];
      bad |= isnan(v.y);
      m = fmaxf(m, v.x);
    }
    m = warp_max(m);
    bad = __any_sync(0xffffffffu, bad);
    float l = 0.f;
    for (int z = lane; z < Z; z += 32) {
      const float2 v = ml[z * zstride + q0 + gh];
      // A split with no valid slot (max -inf) weighs an exact 0.
      const float wz = v.x == -INFINITY ? 0.f : exp2f(v.x - m);
      w_s[gh * Z + z] = wz;
      if (wz != 0.f) l = fmaf(wz, v.y, l);
    }
    l = warp_sum(l);
    if (lane == 0) {
      const float s_new = dot * p.scale_log2;
      const float m_fin = fmaxf(m, s_new);
      const float alpha = m == -INFINITY ? 0.f : exp2f(m - m_fin);
      const float p_new = exp2f(s_new - m_fin);
      const float l_fin = l * alpha + p_new;
      co_s[gh] = alpha / l_fin;
      cn_s[gh] = p_new / l_fin;
      bad_s[gh] = bad ? 1.f : 0.f;
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
        if (wz != 0.f) {  // an unwritten partial never meets a zero weight
          acc.x = fmaf(wz, v[u].x, acc.x);
          acc.y = fmaf(wz, v[u].y, acc.y);
          acc.z = fmaf(wz, v[u].z, acc.z);
          acc.w = fmaf(wz, v[u].w, acc.w);
        }
      }
    }
    const float co = co_s[gh];
    const float cn = cn_s[gh];
    float4 o;
    o.x = acc.x * co + cn * to_f32(new_v[col + d]);
    o.y = acc.y * co + cn * to_f32(new_v[col + d + 1]);
    o.z = acc.z * co + cn * to_f32(new_v[col + d + 2]);
    o.w = acc.w * co + cn * to_f32(new_v[col + d + 3]);
    if (bad_s[gh] != 0.f) o = make_float4(NAN, NAN, NAN, NAN);
    *reinterpret_cast<float4*>(p.out + (q0 + gh) * D + d) = o;
  }
}

// --- bf16 on the tensor cores -------------------------------------------------

constexpr int kBlock = 64;  // slots per K/V block

template <int D, int MT>
struct TcTile {
  static constexpr int kStride = D + 8;  // bf16 per shared row: the 16-byte pad puts
                                         // the 8 rows an ldmatrix reads on distinct banks
  static constexpr int kRows = 16 * MT;  // query rows, padded to m16 tiles
  static constexpr size_t kQBytes = (size_t)kRows * kStride * 2;
  static constexpr size_t kKVBytes = (size_t)2 /*stages*/ * 2 /*K, V*/ * kBlock * kStride * 2;
  static constexpr size_t kSmemBytes = kQBytes + kKVBytes + 2 * kBlock * sizeof(int);
};

// grid (R * chunks, KVH, splits + rpc). Warp w computes S for m16 tile
// w % MT (all 64 slots of a block) and O for head dims (w / MT) * D*MT/4 ..
template <int D, int MT>
__global__ void __launch_bounds__(kThreads) paged_decode_tc(Params p) {
  using Tile = TcTile<D, MT>;
  constexpr int ST = Tile::kStride;
  constexpr int CH = D / 8;          // 16-byte chunks per slot row
  constexpr int KD = D / 16;         // k-steps of S
  constexpr int NT = kBlock / 8;     // n8 tiles of S
  constexpr int DW = D * MT / 4;     // head dims of O per warp
  constexpr int DT = DW / 8;         // n8 tiles of O per warp
  static_assert(DW >= 16, "each warp needs whole 16-column steps of O");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);           // [kRows][ST]
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + Tile::kQBytes);
  int* pos_s = reinterpret_cast<int*>(smem_raw + Tile::kQBytes + Tile::kKVBytes);  // [2][kBlock]
  __shared__ int lim_s[kMaxChunkRows];
  __shared__ int bad_s[kMaxChunkRows];

  Work w;
  if (!setup_work(p, w, lim_s, bad_s)) return;
  const int G = p.QH / p.KVH;
  const int qrows = w.nrows * G;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const __nv_bfloat16* pool_k = static_cast<const __nv_bfloat16*>(p.pool_k);
  const __nv_bfloat16* pool_v = static_cast<const __nv_bfloat16*>(p.pool_v);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);

  // Query rows qr = i*G + gh (row row_lo + i, head h*G + gh); padding rows
  // are zero-filled and never written out.
  for (int c = tid; c < Tile::kRows * CH; c += kThreads) {
    const int qr = c / CH;
    const int ch = c % CH;
    const bool ok = qr < qrows;
    const size_t qi = ok ? (size_t)(w.row_lo + qr / G) * p.QH + (size_t)w.h * G + qr % G : 0;
    cp_async_16(q_s + qr * ST + ch * 8, q + qi * D + ch * 8, ok ? 16 : 0);
  }
  const int n_blocks = (w.t_end - w.t_begin + kBlock - 1) / kBlock;
  auto load_block = [&](int blk, int stage) {
    const int t0 = w.t_begin + blk * kBlock;
    __nv_bfloat16* ks = kv_s + stage * 2 * kBlock * ST;
    __nv_bfloat16* vs = ks + kBlock * ST;
    for (int c = tid; c < kBlock * CH; c += kThreads) {
      const int rr = c / CH;
      const int ch = c % CH;
      int pos;
      const long long off = slot_offset(p, w, t0 + rr, D, pos);
      const size_t src = off < 0 ? 0 : (size_t)off + ch * 8;
      cp_async_16(ks + rr * ST + ch * 8, pool_k + src, off < 0 ? 0 : 16);
      cp_async_16(vs + rr * ST + ch * 8, pool_v + src, off < 0 ? 0 : 16);
    }
    for (int rr = tid; rr < kBlock; rr += kThreads) {
      int pos;
      slot_offset(p, w, t0 + rr, D, pos);
      pos_s[stage * kBlock + rr] = pos;
    }
  };
  if (n_blocks > 0) load_block(0, 0);
  cp_async_commit();

  const int mt = warp % MT;
  const int d0 = (warp / MT) * DW;  // the warp's first head dim of O
  const int qr0 = mt * 16 + g;      // the lane's query rows qr0 and qr0 + 8
  const int lim[2] = {qr0 < qrows ? lim_s[qr0 / G] : -1, qr0 + 8 < qrows ? lim_s[(qr0 + 8) / G] : -1};
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
    const int* pos_b = pos_s + (it & 1) * kBlock;

    // S = Q K^T for the tile's 16 rows x 64 slots.
    float s[NT][4];  // started by the first k-step
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t qa[4];
      ldmatrix_x4(qa, q_frag + kd * 16);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        // Slots np*16 .. +15 at head dims kd*16 .. +15: two B fragments.
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
        const int pos = pos_b[nt * 8 + 2 * t + (e & 1)];
        const float x = pos >= 0 && pos < lim[e >> 1] ? s[nt][e] * p.scale_log2 : -INFINITY;
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
      // A row with no valid slot yet keeps m = -inf; exponents are then
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

    // O += P V over 16-slot steps. The score fragment of slots 16kk .. +15
    // is the A fragment of the step; P = P_hi + P_mid + P_lo, all bf16, all
    // multiplied into the f32 accumulator.
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk) {
      uint32_t ph[4], pm[4], pl[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // j: (row g, slots 2t..), (row g+8, 2t..), (row g, 8+2t..), (row g+8, 8+2t..)
        const int nt = 2 * kk + (j >> 1);
        const int e = (j & 1) * 2;
        const float p0 = exp2f(s[nt][e] - m_use[j & 1]);
        const float p1 = exp2f(s[nt][e + 1] - m_use[j & 1]);
        l[j & 1] += p0 + p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 hf = __bfloat1622float2(hi);
        const float r0 = p0 - hf.x;
        const float r1 = p1 - hf.y;
        const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
        const float2 mf = __bfloat1622float2(mid);
        ph[j] = *reinterpret_cast<const uint32_t*>(&hi);
        pm[j] = *reinterpret_cast<const uint32_t*>(&mid);
        pl[j] = pack_bf16x2(r0 - mf.x, r1 - mf.y);
      }
#pragma unroll
      for (int dq = 0; dq < DT / 2; ++dq) {
        // Slots 16kk .. +15 at head dims d0 + dq*16 .. +15, transposed: two B fragments.
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ST + d0 +
                                  dq * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dq], ph, vb[0], vb[1]);
        mma_bf16(o[2 * dq + 1], ph, vb[2], vb[3]);
        mma_bf16(o[2 * dq], pm, vb[0], vb[1]);
        mma_bf16(o[2 * dq + 1], pm, vb[2], vb[3]);
        mma_bf16(o[2 * dq], pl, vb[0], vb[1]);
        mma_bf16(o[2 * dq + 1], pl, vb[2], vb[3]);
      }
    }
  }
  cp_async_wait<0>();

  // Partials of the lane's rows: unnormalised O, and (from the warps of the
  // first head-dim slice) the max and the denominator, NaN for a bad row.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int qr = qr0 + 8 * i;
    if (qr >= qrows) continue;
    const size_t qi = (size_t)(w.row_lo + qr / G) * p.QH + (size_t)w.h * G + qr % G;
    const size_t slot = (size_t)w.zi * p.B * p.QH + qi;
    float* op = p.o_part + slot * D + d0 + 2 * t;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<float2*>(op + dt * 8) = make_float2(o[dt][2 * i], o[dt][2 * i + 1]);
    }
    if (d0 == 0 && t == 0) {
      reinterpret_cast<float2*>(p.ml_part)[slot] =
          make_float2(m[i], bad_s[qr / G] ? NAN : l[i]);
    }
  }
}

// --- f32 (and bf16 at D = 16) on the CUDA cores ------------------------------

constexpr int kSimtBlock = 32;  // slots per K/V block (one per lane)

template <typename T, int D>
struct SimtTile {
  static constexpr int kRows = kThreads * kMaxPairsPerThread / D;  // query rows at most
  static constexpr int kStride = D + 16 / (int)sizeof(T);          // elements per shared row
  static constexpr size_t kKVBytes = (size_t)2 * kSimtBlock * kStride * sizeof(T);
  static constexpr size_t kSmemBytes =
      kKVBytes + ((size_t)kRows * D + (size_t)kRows * kSimtBlock + 3 * kRows) * sizeof(float) +
      kSimtBlock * sizeof(int);
};

// grid (R * chunks, KVH, splits + rpc); thread `tid` owns the (query row,
// head dim) pairs tid + i * 128.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) paged_decode_simt(Params p) {
  using Tile = SimtTile<T, D>;
  constexpr int ST = Tile::kStride;
  constexpr int kVec = 16 / (int)sizeof(T);  // elements per 16-byte copy
  constexpr int CH = D / kVec;
  static_assert(D % kVec == 0, "unsupported head dim");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);  // [kSimtBlock][ST]
  T* v_s = k_s + kSimtBlock * ST;
  float* q_s = reinterpret_cast<float*>(smem_raw + Tile::kKVBytes);  // [kRows][D]
  float* p_s = q_s + Tile::kRows * D;                                // [kRows][kSimtBlock]
  float* m_s = p_s + Tile::kRows * kSimtBlock;                       // [kRows] running max
  float* l_s = m_s + Tile::kRows;                                    // [kRows] denominator
  float* a_s = l_s + Tile::kRows;                                    // [kRows] block rescale
  int* pos_s = reinterpret_cast<int*>(a_s + Tile::kRows);            // [kSimtBlock]
  __shared__ int lim_s[kMaxChunkRows];
  __shared__ int bad_s[kMaxChunkRows];

  Work w;
  if (!setup_work(p, w, lim_s, bad_s)) return;
  const int G = p.QH / p.KVH;
  const int qrows = w.nrows * G;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const T* pool_k = static_cast<const T*>(p.pool_k);
  const T* pool_v = static_cast<const T*>(p.pool_v);
  const T* q = static_cast<const T*>(p.q);

  for (int idx = tid; idx < qrows * D; idx += kThreads) {
    const int qr = idx / D;
    const size_t qi = (size_t)(w.row_lo + qr / G) * p.QH + (size_t)w.h * G + qr % G;
    q_s[idx] = to_f32(q[qi * D + idx % D]);
  }
  for (int qr = tid; qr < qrows; qr += kThreads) {
    m_s[qr] = -INFINITY;
    l_s[qr] = 0.f;
  }
  float acc[kMaxPairsPerThread];
#pragma unroll
  for (int i = 0; i < kMaxPairsPerThread; ++i) acc[i] = 0.f;

  for (int t0 = w.t_begin; t0 < w.t_end; t0 += kSimtBlock) {
    __syncthreads();  // every thread is done with the previous block
    for (int c = tid; c < kSimtBlock * CH; c += kThreads) {
      const int rr = c / CH;
      const int ch = c % CH;
      int pos;
      const long long off = slot_offset(p, w, t0 + rr, D, pos);
      const size_t src = off < 0 ? 0 : (size_t)off + ch * kVec;
      cp_async_16(k_s + rr * ST + ch * kVec, pool_k + src, off < 0 ? 0 : 16);
      cp_async_16(v_s + rr * ST + ch * kVec, pool_v + src, off < 0 ? 0 : 16);
    }
    cp_async_commit();
    for (int rr = tid; rr < kSimtBlock; rr += kThreads) {
      int pos;
      slot_offset(p, w, t0 + rr, D, pos);
      pos_s[rr] = pos;
    }
    cp_async_wait<0>();
    __syncthreads();

    // Scores (log2 units); masked slots get -inf, which no max selects and
    // exp2 turns into an exact 0.
    for (int idx = tid; idx < qrows * kSimtBlock; idx += kThreads) {
      const int qr = idx / kSimtBlock;
      const int o = idx % kSimtBlock;
      const int pos = pos_s[o];
      float sc = -INFINITY;
      if (pos >= 0 && pos < lim_s[qr / G]) {
        const T* kr = k_s + o * ST;
        const float* qg = q_s + qr * D;
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot = fmaf(qg[d], to_f32(kr[d]), dot);
        sc = dot * p.scale_log2;
      }
      p_s[idx] = sc;
    }
    __syncthreads();

    // Online-softmax update, one warp per query row, one lane per slot.
    for (int qr = warp; qr < qrows; qr += kWarps) {
      const float x = p_s[qr * kSimtBlock + lane];
      const float m_old = m_s[qr];
      const float m_new = fmaxf(m_old, warp_max(x));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float pr = exp2f(x - m_use);
      p_s[qr * kSimtBlock + lane] = pr;
      const float sum = warp_sum(pr);
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_use);
        a_s[qr] = alpha;
        l_s[qr] = l_s[qr] * alpha + sum;
        m_s[qr] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kMaxPairsPerThread; ++i) {
      const int pair = tid + i * kThreads;
      if (pair < qrows * D) {
        const int qr = pair / D;
        const int d = pair % D;
        const float* pg = p_s + qr * kSimtBlock;
        float a = acc[i] * a_s[qr];
        for (int o = 0; o < kSimtBlock; ++o) a = fmaf(pg[o], to_f32(v_s[o * ST + d]), a);
        acc[i] = a;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kMaxPairsPerThread; ++i) {
    const int pair = tid + i * kThreads;
    if (pair < qrows * D) {
      const int qr = pair / D;
      const size_t qi = (size_t)(w.row_lo + qr / G) * p.QH + (size_t)w.h * G + qr % G;
      p.o_part[((size_t)w.zi * p.B * p.QH + qi) * D + pair % D] = acc[i];
    }
  }
  for (int qr = tid; qr < qrows; qr += kThreads) {
    const size_t qi = (size_t)(w.row_lo + qr / G) * p.QH + (size_t)w.h * G + qr % G;
    reinterpret_cast<float2*>(p.ml_part)[(size_t)w.zi * p.B * p.QH + qi] =
        make_float2(m_s[qr], bad_s[qr / G] ? NAN : l_s[qr]);
  }
}

// The split kernel, then the merge.
template <typename T, int D, typename K>
int launch_pair(K split_kernel, size_t smem, const Params& p, int R, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  split_kernel<<<dim3(R * p.chunks, p.KVH, p.splits + p.rpc), kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t merge_smem = (size_t)(p.QH / p.KVH) * (p.splits + 4) * sizeof(float);
  err = cudaFuncSetAttribute(paged_decode_merge<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)merge_smem);
  if (err != cudaSuccess) return (int)err;
  paged_decode_merge<T, D><<<dim3(p.B, p.KVH), kThreads, merge_smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_tc(const Params& p, int R, cudaStream_t stream) {
  const int rows = p.rpc * (p.QH / p.KVH);
  if (rows <= 16) {
    return launch_pair<__nv_bfloat16, D>(paged_decode_tc<D, 1>, TcTile<D, 1>::kSmemBytes, p, R,
                                         stream);
  }
  if (rows <= 32) {
    return launch_pair<__nv_bfloat16, D>(paged_decode_tc<D, 2>, TcTile<D, 2>::kSmemBytes, p, R,
                                         stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, int D>
int launch_simt(const Params& p, int R, cudaStream_t stream) {
  using Tile = SimtTile<T, D>;
  if (p.rpc * (p.QH / p.KVH) > Tile::kRows) return (int)cudaErrorInvalidValue;
  return launch_pair<T, D>(paged_decode_simt<T, D>, Tile::kSmemBytes, p, R, stream);
}

}  // namespace

// Plain C entry point for ctypes. `route` is the split kernel the wrapper
// chose (0 the CUDA-core kernel, 1 the tensor-core kernel, bf16 only);
// `rpc` rows of a request per CTA and `splits` prefix splits follow
// ops/paged_attention.py::paged_split_plan. `o_part` / `ml_part` are f32
// scratch of (splits + 1) * B * QH * D and (splits + 1) * B * QH * 2
// floats. Returns the CUDA status of the launches (0 = success).
extern "C" int kllms_paged_decode_attention(
    const void* q, const void* pool_k, const void* pool_v, const int* prefix_pages,
    const int* gen_pages, const int* gen_phase, const void* new_k, const void* new_v,
    const int* prompt_lens, const int* gen_lens, float* out, float* o_part, float* ml_part,
    int B, int QH, int KVH, int D, int R, int NP, int NG, int page_size,
    int num_pages, int is_bf16, int route, int rpc, int splits, float sm_scale, void* stream) {
  if (B <= 0 || QH <= 0 || KVH <= 0 || QH % KVH != 0 || R <= 0 || B % R != 0 ||
      page_size <= 0 || num_pages <= 0 || NP < 0 || NG < 0 || splits <= 0 || rpc <= 0 ||
      rpc > B / R || rpc > kMaxChunkRows ||
      (QH / KVH) * D > kThreads * kMaxPairsPerThread || splits + rpc > 65535 || splits > 4096 ||
      (route == 1 && !is_bf16) || route < 0 || route > 1) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.q = q;
  p.pool_k = pool_k;
  p.pool_v = pool_v;
  p.prefix_pages = prefix_pages;
  p.gen_pages = gen_pages;
  p.gen_phase = gen_phase;
  p.new_k = new_k;
  p.new_v = new_v;
  p.prompt_lens = prompt_lens;
  p.gen_lens = gen_lens;
  p.out = out;
  p.o_part = o_part;
  p.ml_part = ml_part;
  p.B = B;
  p.QH = QH;
  p.KVH = KVH;
  p.n_per = B / R;
  p.NP = NP;
  p.NG = NG;
  p.ps = page_size;
  p.num_pages = num_pages;
  p.rpc = rpc;
  p.chunks = (p.n_per + rpc - 1) / rpc;
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
