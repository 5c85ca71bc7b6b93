// Attention through a paged KV cache's block table, shared by the decode
// kernel (paged_attention.cu) and the chunked-prefill kernel
// (flash_prefill.cu). Both compute the same function: a tile of query rows
// of one (sequence row, KV head) pair attends causally over that row's K/V,
// which lives in fixed-size blocks of a shared pool and is found through
// the row's block table. Decode is the chunk of one position.
//
// Layouts (all contiguous):
//   q, out   (B, C, H, HD)              query chunk; H = KV * G
//   k_pool   (n_blocks, block, KV, HD)  one layer's slice of the pool
//   v_pool   (n_blocks, block, KV, HD)
//   table    (B, bpr) int32             physical block ids, -1 unallocated
//   pos0     (B,) int32                 per-row position base
// Query rows of one (b, h) are c-major: row r is chunk position c = r / G,
// group member g = r % G (head h * G + g), and sees key positions
// [0, pos0[b] + bias + c]. Decode passes cur_len with bias -1, prefill
// passes the chunk offset with bias 0.
//
// Semantics shared with the plain PyTorch versions (ref.py):
//   - table entries < 0 read physical block 0; those lanes are masked;
//   - key positions at or past bpr * block do not exist;
//   - scores, softmax and the accumulator are fp32, q is scaled in fp32;
//   - a row that sees no position (decode with cur_len == 0) returns 0.
//
// Design for the H100: the work is bound by the bytes of K/V read (one
// pass over each visible position of each (row, KV head)). One CTA holds
// RT query rows that share a KV head, so every K/V element it loads from
// device memory serves all G heads of the group (and, in prefill, every
// chunk position of the tile). The CTA walks the row's positions in tiles
// of TT = 32 (one warp's lanes), loading each tile's K and V through the
// table into shared memory, and stops at the tile's last visible position:
// blocks past a row's length are never read. Scores and the online softmax
// run one warp per query row with a lane per key position; the fp32
// accumulator lives in registers, each thread owning fixed (row, dim)
// elements. wgmma, TMA and split-K over long rows are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr float NEG_INF = -1e30f;
constexpr int TT = 32;   // key positions per tile: one lane each
constexpr int NT = 128;  // threads per CTA

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

template <typename T, int HD, int RT>
__global__ void __launch_bounds__(NT) block_table_attention(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ table,
    const int* __restrict__ pos0, int bias, T* __restrict__ out, int C,
    int H, int KV, int block, int bpr, float scale) {
  static_assert((RT * HD) % NT == 0, "accumulator split");
  constexpr int PER = RT * HD / NT;
  constexpr int NW = NT / 32;

  const int b = blockIdx.x, h = blockIdx.y;
  const int G = H / KV;
  const int r0 = blockIdx.z * RT;
  const int nr = min(RT, C * G - r0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  __shared__ float q_s[RT][HD];
  __shared__ float k_s[TT][HD + 1];  // +1: lanes read distinct banks
  __shared__ float v_s[TT][HD];
  __shared__ float p_s[RT][TT];
  __shared__ float m_s[RT], l_s[RT], corr_s[RT];
  __shared__ long long base_s[TT];

  const int off = pos0[b] + bias;
  // one past the last key position any row of this tile sees
  const int n_pos = min(off + (r0 + nr - 1) / G + 1, bpr * block);

  for (int i = tid; i < RT * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    float x = 0.f;
    if (r < nr) {
      const int c = (r0 + r) / G, g = (r0 + r) % G;
      x = to_f(q[((long long)(b * C + c) * H + h * G + g) * HD + d]) * scale;
    }
    q_s[r][d] = x;
  }
  if (tid < RT) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) acc[e] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < n_pos; t0 += TT) {
    if (tid < TT) {
      const int pos = t0 + tid;
      long long base = -1;
      if (pos < n_pos) {
        const int blk = max(table[b * bpr + pos / block], 0);
        base = ((long long)blk * block + pos % block) * KV * HD +
               (long long)h * HD;
      }
      base_s[tid] = base;
    }
    __syncthreads();
    for (int i = tid; i < TT * HD; i += NT) {
      const int t = i / HD, d = i % HD;
      const long long base = base_s[t];
      float kx = 0.f, vx = 0.f;
      if (base >= 0) {
        kx = to_f(k_pool[base + d]);
        vx = to_f(v_pool[base + d]);
      }
      k_s[t][d] = kx;
      v_s[t][d] = vx;
    }
    __syncthreads();

    for (int r = warp; r < RT; r += NW) {
      const int pos = t0 + lane;
      float s = NEG_INF;
      if (r < nr && pos < n_pos && pos <= off + (r0 + r) / G) {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) dot += q_s[r][d] * k_s[lane][d];
        s = dot;
      }
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p = expf(s - m_new);
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      p_s[r][lane] = p;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        corr_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int i = tid + e * NT;
      const int r = i / HD, d = i % HD;
      float a = acc[e] * corr_s[r];
#pragma unroll 8
      for (int t = 0; t < TT; ++t) a += p_s[r][t] * v_s[t][d];
      acc[e] = a;
    }
    __syncthreads();
  }

#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int i = tid + e * NT;
    const int r = i / HD, d = i % HD;
    if (r < nr) {
      const int c = (r0 + r) / G, g = (r0 + r) % G;
      out[((long long)(b * C + c) * H + h * G + g) * HD + d] =
          from_f<T>(acc[e] / fmaxf(l_s[r], 1e-30f));
    }
  }
}

// Host-side launch over the two element types and head widths the port
// serves (hd 64: smollm, llama; hd 128: olmo, qwen2). Returns the launch
// status; an unsupported combination returns cudaErrorInvalidValue.
template <int RT>
inline int launch_block_table_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* pos0, int bias, void* out, int B, int C, int H, int KV,
    int hd, int block, int bpr, int dtype, void* stream) {
  if (B <= 0 || C <= 0 || KV <= 0 || H % KV != 0 || block <= 0 || bpr <= 0)
    return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  const dim3 grid(B, KV, (C * G + RT - 1) / RT);
  const float scale = 1.0f / sqrtf((float)hd);
  cudaStream_t s = (cudaStream_t)stream;
  const int* tb = (const int*)table;
  const int* p0 = (const int*)pos0;
#define REPRO_LAUNCH(T, HDV)                                             \
  block_table_attention<T, HDV, RT><<<grid, NT, 0, s>>>(                 \
      (const T*)q, (const T*)k_pool, (const T*)v_pool, tb, p0, bias,     \
      (T*)out, C, H, KV, block, bpr, scale)
  if (dtype == 0 && hd == 64) {
    REPRO_LAUNCH(float, 64);
  } else if (dtype == 0 && hd == 128) {
    REPRO_LAUNCH(float, 128);
  } else if (dtype == 1 && hd == 64) {
    REPRO_LAUNCH(__nv_bfloat16, 64);
  } else if (dtype == 1 && hd == 128) {
    REPRO_LAUNCH(__nv_bfloat16, 128);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef REPRO_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace repro
