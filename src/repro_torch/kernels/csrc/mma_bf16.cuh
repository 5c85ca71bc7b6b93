// Tensor-core fragments for bf16 attention: mma.sync m16n8k16 with fp32
// accumulation, and the loads that feed it. Shared by flash_attention.cu
// and flash_prefill.cu.
//
// Fragment layout of m16n8k16 (row.col), for lane = 4 * g + t:
//   A (16 x 16, row-major): a[0] = A[g][2t..2t+1],  a[1] = A[g+8][2t..],
//                           a[2] = A[g][2t+8..],    a[3] = A[g+8][2t+8..]
//   B (16 x 8, "col"):      b0 = B[2t..2t+1][g],    b1 = B[2t+8..2t+9][g]
//   C (16 x 8, fp32):       c[0..1] = C[g][2t..2t+1], c[2..3] = C[g+8][2t..]
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace repro {

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 (16 contiguous bytes). Lane 4g + t receives
// elements (g, 2t..2t+1) of each matrix, or with .trans elements
// (2t..2t+1, g).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* smem) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

}  // namespace repro
