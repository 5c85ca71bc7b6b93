// Attention through a paged KV cache's block table: what the decode
// kernel (paged_attention.cu) and the chunked-prefill kernel
// (flash_prefill.cu) share. Both compute the same function: query rows of
// one (sequence row, KV head) pair attend causally over that row's K/V,
// which lives in fixed-size blocks of a shared pool and is found through
// the row's block table. Decode is the chunk of one position.
//
// Layouts (all contiguous, every operand 16-byte aligned):
//   q, out   (B, C, H, HD)              query chunk; H = KV * G
//   k_pool   (n_blocks, block, KV, HD)  one layer's slice of the pool
//   v_pool   (n_blocks, block, KV, HD)
//   table    (B, bpr) int32             physical block ids, -1 unallocated
//   pos0     (B,) int32                 cur_len (decode) or q_off (prefill)
// Query rows of one (b, h) are c-major: row r is chunk position c = r / G,
// group member g = r % G (head h * G + g). Prefill row r sees key
// positions [0, q_off[b] + c]; a decode row sees [0, cur_len[b] - 1].
//
// Semantics shared with the plain PyTorch versions (ref.py):
//   - table entries < 0 read physical block 0; those lanes are masked;
//   - key positions at or past bpr * block do not exist;
//   - scores, softmax and the accumulator are fp32, q is scaled in fp32;
//   - a row that sees no position (decode with cur_len == 0) returns 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// A block size and, when it is a power of two, its log2 (else -1), so that
// a position's table column is a shift rather than an integer division.
struct BlockSize {
  int size, shift;
  static BlockSize of(int size) {
    int shift = -1;
    if (size > 0 && (size & (size - 1)) == 0)
      for (shift = 0; (1 << shift) < size; ++shift) {
      }
    return {size, shift};
  }
  __device__ __forceinline__ int col(int pos) const {
    return shift >= 0 ? pos >> shift : pos / size;
  }
};

// Element offset of (position pos, KV head h, dim 0) of a row's K/V in
// the pool, through the block table row `trow`: -1 entries read block 0.
__device__ __forceinline__ long long kv_offset(const int* trow, int pos,
                                               BlockSize bs, int KV, int h,
                                               int hd) {
  const int c = bs.col(pos);
  const int blk = max(__ldg(trow + c), 0);
  return ((long long)blk * bs.size + (pos - c * bs.size)) * KV * hd +
         (long long)h * hd;
}

// 16-byte asynchronous copy global -> shared; with `valid` false nothing
// is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Raise a kernel's dynamic shared memory limit once per process.
template <typename Kernel>
inline int allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done || bytes <= 48 * 1024) return 0;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == 0;
  return err;
}

}  // namespace repro
