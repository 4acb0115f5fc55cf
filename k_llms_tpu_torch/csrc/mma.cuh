// Warp-level tensor-core helpers for Hopper (sm_90a) kernels written by hand:
// asynchronous global-to-shared copies (cp.async), shared-to-register
// fragment loads (ldmatrix) and the bf16 tensor-core product
// mma.sync.m16n8k16 with f32 accumulation.
//
// Fragment layouts of mma.m16n8k16.row.col (lane = 4 * g + t):
//   A (16 x 16, row-major) a[0..3]: (row g, k 2t..2t+1), (row g+8, k 2t..),
//     (row g, k 2t+8..), (row g+8, k 2t+8..); two bf16 per register, the
//     lower k in the low half.
//   B (16 x 8, k x n) b[0..1]: (k 2t..2t+1, col g), (k 2t+8..2t+9, col g).
//   C/D (16 x 8, f32) c[0..3]: (row g, cols 2t, 2t+1), (row g+8, cols 2t, 2t+1).
// ldmatrix.x4 loads four 8 x 8 b16 matrices whose rows are addressed by
// lanes 0-7, 8-15, 16-23 and 24-31; lane (g, t) receives elements
// [g][2t..2t+1] of each (with .trans: [2t][g] and [2t+1][g]).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace kllms {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy from global to shared memory, not waited for. With
// src_bytes == 0 nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `Pending` committed copy groups are still in flight.
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a @ b on the tensor cores: bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a @ b (a zero accumulator, which the compiler need not materialise).
__device__ __forceinline__ void mma_bf16_zero(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// Two floats rounded to bf16, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace kllms
