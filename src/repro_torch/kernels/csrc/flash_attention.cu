// Full-sequence GQA attention forward, causal or not:
//   o[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h/G] / sqrt(D)) v[b, j, h/G]
// over keys j <= i (top-left alignment, also when T != S) when causal, all
// T keys otherwise. q (B, S, H, D); k, v (B, T, KV, D); o (B, S, H, D),
// G = H / KV. All math in fp32 for both operand types, as the TPU kernel.
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py
// (_fa_kernel, launched by flash_attention's pallas_call).
//
// What bounds it on the H100: operations. At the llama3.2-1b forward's
// shapes (B=4, S=T=2048, H=32, KV=8, D=64, causal) the two products are
// 4*D*H*B*S*(S+1)/2 = 68.7 GFLOP: 0.069 ms at the 989 TFLOP/s of bf16
// tensor cores, 1.03 ms at the 67 TFLOP/s of fp32 FMAs, against 84 MB of
// bf16 operands and result (0.025 ms at 3.35 TB/s). Two routes, one per
// operand type:
//
// - bf16 (the model's compute type): QK^T and PV on the tensor cores,
//   mma.sync m16n8k16 with fp32 accumulation; scores, the online softmax
//   and the accumulator stay fp32, and p is rounded to bf16 for the PV
//   product (the TPU kernel keeps p in fp32: at most 2^-8 relative on
//   each weight, the size of the bf16 output's own rounding). wgmma and
//   TMA are later work.
// - fp32: every multiply-add on the fp32 pipes (no TF32), bounded by the
//   1.03 ms.
//
// bf16 design. One CTA of four warps per (query tile of 64 rows, head,
// batch row); warp w owns rows 16w..16w+15, holds its q rows as mma A
// fragments in registers for the whole key loop, and keeps its scores,
// row max, row sum and 16 x D fp32 accumulator in mma C fragments (each
// thread: two rows, two columns per 8-wide tile; row statistics are
// combined across the 4 threads of a row with shuffles). Per key tile
// of 64, K is staged in shared memory row-major (a B fragment of QK^T is
// one 32-bit load) and V transposed (a B fragment of PV is one 32-bit
// load); both rows are padded by 16 bytes, so the fragment loads of a
// warp hit 32 different banks. The score fragments become the A
// fragments of PV in registers. Scale and masks are applied to the fp32
// scores, as the TPU kernel applies them.
//
// fp32 design. One CTA per (query tile of 64 rows, head, batch row): the TPU
// grid's sequential key axis becomes a loop inside the CTA, which keeps
// the online-softmax state in registers. Each query row is owned by
// TPR = D/32 adjacent threads (1 for D <= 32), each holding 32 (or D)
// dimensions of the scaled q row and of the fp32 accumulator; a score's
// partial dot products are summed across the row's threads with a
// butterfly of shuffles, so every thread of a row holds the same score,
// row max m and row sum l. K and V tiles of BK keys (64, or 32 at D=128)
// are staged in shared memory as fp32 by all threads; a thread reads them
// as 16-byte broadcasts, and the dimension slices of a row interleave at
// 16-byte granularity, so the TPR threads of a row read TPR neighbouring
// 16-byte words (no bank conflicts).
//
// Both routes: causal attention stops the key loop after the tile
// holding the CTA's last query (the TPU kernel's skip of whole blocks
// above the diagonal) and masks inside it with -1e30, as the TPU kernel
// does. Ragged S and T edges are masked (keys past T get probability 0;
// rows past S are computed and not stored), though the model only sends
// multiples of 128. Precise expf; the result is acc / max(l, 1e-30),
// written in the operands' type.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kRows = 64;             // query rows per CTA
constexpr float kNegInf = -1e30f;     // the TPU kernel's mask value

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <int D>
struct Shape {
  static constexpr int kDpt = D < 32 ? D : 32;       // dims per thread
  static constexpr int kTpr = D / kDpt;               // threads per row
  static constexpr int kChunks = kDpt / 4;            // 16-byte words per thread
  static constexpr int kThreads = kRows * kTpr;
  static constexpr int kKeys = D == 128 ? 32 : 64;    // keys per tile (BK)
  static constexpr int kTileLoads = kKeys * (D / 4) / kThreads;
};

template <int D>
__global__ void __launch_bounds__(Shape<D>::kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int S, int T_len, int H, int KV, int causal,
                       float scale) {
  using Sh = Shape<D>;
  constexpr int BK = Sh::kKeys;
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const int tid = threadIdx.x;
  const int row = tid / Sh::kTpr;
  const int slice = tid % Sh::kTpr;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int qpos = q0 + row;
  const bool live = qpos < S;

  // this thread's 16-byte words of a D-wide row: word i*TPR + slice
  float qr[Sh::kDpt], acc[Sh::kDpt];
  const size_t q_off = ((static_cast<size_t>(b) * S + qpos) * H + h) * D;
#pragma unroll
  for (int i = 0; i < Sh::kChunks; ++i) {
    const int d = 4 * (i * Sh::kTpr + slice);
    if (live) {
      load4(q + q_off + d, qr + 4 * i);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) qr[4 * i + e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qr[4 * i + e] *= scale;
      acc[4 * i + e] = 0.f;
    }
  }
  float m = kNegInf, l = 0.f;

  const int n_tiles = (T_len + BK - 1) / BK;
  int end = n_tiles;
  if (causal) {
    const int last_q = min(q0 + kRows, S) - 1;
    end = min(n_tiles, last_q / BK + 1);
  }

  for (int t = 0; t < end; ++t) {
    const int k0 = t * BK;
    __syncthreads();                    // the previous tile is consumed
#pragma unroll
    for (int it = 0; it < Sh::kTileLoads; ++it) {
      const int e = tid + it * Sh::kThreads;
      const int j = e / (D / 4);
      const int d = 4 * (e % (D / 4));
      float kk[4] = {0.f, 0.f, 0.f, 0.f}, vv[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + j < T_len) {
        const size_t off =
            ((static_cast<size_t>(b) * T_len + k0 + j) * KV + kvh) * D + d;
        load4(k + off, kk);
        load4(v + off, vv);
      }
      store4(&ks[j][d], kk);
      store4(&vs[j][d], vv);
    }
    __syncthreads();

    float s[BK];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < Sh::kChunks; ++i) {
        float kk[4];
        load4(&ks[j][4 * (i * Sh::kTpr + slice)], kk);
#pragma unroll
        for (int e = 0; e < 4; ++e) dot = fmaf(qr[4 * i + e], kk[e], dot);
      }
#pragma unroll
      for (int off = Sh::kTpr / 2; off > 0; off /= 2)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const int key = k0 + j;
      if (key >= T_len) {
        dot = __int_as_float(0xff800000);   // -inf: probability 0
      } else if (causal && key > qpos) {
        dot = kNegInf;
      }
      s[j] = dot;
      tile_max = fmaxf(tile_max, dot);
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < Sh::kDpt; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
#pragma unroll
      for (int i = 0; i < Sh::kChunks; ++i) {
        float vv[4];
        load4(&vs[j][4 * (i * Sh::kTpr + slice)], vv);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[4 * i + e] = fmaf(s[j], vv[e], acc[4 * i + e]);
      }
    }
  }

  if (!live) return;
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < Sh::kChunks; ++i) {
    float out[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] = acc[4 * i + e] / denom;
    store4(o + q_off + 4 * (i * Sh::kTpr + slice), out);
  }
}

// ------------------------------------------------------------ bf16 route

constexpr int kMmaKeys = 64;          // keys per tile
constexpr int kMmaThreads = 128;      // four warps, 16 query rows each
constexpr int kPad = 8;               // bf16 elements (16 bytes) per row

using repro::ld32;
using repro::mma_bf16;
using repro::pack_bf16;

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o, int S, int T_len,
                           int H, int KV, int causal, float scale) {
  constexpr int BK = kMmaKeys;
  constexpr int KC = (D + 15) / 16;   // k16 chunks of a q row
  constexpr bool kHalf = D % 16 != 0;  // D = 8: the last chunk's upper
                                       // half is zero padding
  constexpr int NT = BK / 8;          // n8 tiles of a score row
  constexpr int DT = D / 8;           // n8 tiles of an output row
  __shared__ __align__(16) __nv_bfloat16 ks[BK][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 vt[D][BK + kPad];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;      // mma group and thread in it
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int r0 = q0 + 16 * warp + g;         // this thread's two rows
  const int r1 = r0 + 8;

  uint32_t qa[KC][4];
  const size_t qs = static_cast<size_t>(H) * D;
  const __nv_bfloat16* q_r0 = q + (static_cast<size_t>(b) * S + r0) * qs +
                              static_cast<size_t>(h) * D;
  const __nv_bfloat16* q_r1 = q_r0 + 8 * qs;
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    const int d = 16 * c + 2 * t;
    const bool hi = !(kHalf && c == KC - 1);
    qa[c][0] = r0 < S ? ld32(q_r0 + d) : 0u;
    qa[c][1] = r1 < S ? ld32(q_r1 + d) : 0u;
    qa[c][2] = r0 < S && hi ? ld32(q_r0 + d + 8) : 0u;
    qa[c][3] = r1 < S && hi ? ld32(q_r1 + d + 8) : 0u;
  }
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;   // per-thread l

  const int n_tiles = (T_len + BK - 1) / BK;
  int end = n_tiles;
  if (causal) end = min(n_tiles, (min(q0 + kRows, S) - 1) / BK + 1);

  for (int tile = 0; tile < end; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();                    // the previous tile is consumed
    // K row-major: thread -> (key, 16-byte chunk), coalesced along D
#pragma unroll
    for (int e = tid; e < BK * D / 8; e += kMmaThreads) {
      const int j = e / (D / 8), d = 8 * (e % (D / 8));
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + j < T_len)
        val = *reinterpret_cast<const uint4*>(
            k + ((static_cast<size_t>(b) * T_len + k0 + j) * KV + kvh) * D +
            d);
      *reinterpret_cast<uint4*>(&ks[j][d]) = val;
    }
    // V transposed: thread -> (key, 16-byte chunk), keys fastest, so a
    // warp's 2-byte stores fill whole words of one vt row
#pragma unroll
    for (int e = tid; e < BK * D / 8; e += kMmaThreads) {
      const int j = e % BK, d = 8 * (e / BK);
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + j < T_len)
        val = *reinterpret_cast<const uint4*>(
            v + ((static_cast<size_t>(b) * T_len + k0 + j) * KV + kvh) * D +
            d);
      const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) vt[d + i][j] = x[i];
    }
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int c = 0; c < KC; ++c)
        mma_bf16(s[n], qa[c], ld32(&ks[8 * n + g][16 * c + 2 * t]),
                 kHalf && c == KC - 1
                     ? 0u : ld32(&ks[8 * n + g][16 * c + 8 + 2 * t]));
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * n + 2 * t + (e & 1);
        const int row = e < 2 ? r0 : r1;
        float x = s[n][e] * scale;
        if (key >= T_len) {
          x = __int_as_float(0xff800000);   // -inf: probability 0
        } else if (causal && key > row) {
          x = kNegInf;
        }
        s[n][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = expf(s[n][0] - mn0);
      s[n][1] = expf(s[n][1] - mn0);
      s[n][2] = expf(s[n][2] - mn1);
      s[n][3] = expf(s[n][3] - mn1);
      ps0 += s[n][0] + s[n][1];
      ps1 += s[n][2] + s[n][3];
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][0] *= c0; acc[j][1] *= c0;
      acc[j][2] *= c1; acc[j][3] *= c1;
    }
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
      const uint32_t pa[4] = {pack_bf16(s[2 * c][0], s[2 * c][1]),
                              pack_bf16(s[2 * c][2], s[2 * c][3]),
                              pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                              pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
      for (int j = 0; j < DT; ++j)
        mma_bf16(acc[j], pa, ld32(&vt[8 * j + g][16 * c + 2 * t]),
                 ld32(&vt[8 * j + g][16 * c + 8 + 2 * t]));
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* o_r0 = o + (static_cast<size_t>(b) * S + r0) * qs +
                        static_cast<size_t>(h) * D;
  __nv_bfloat16* o_r1 = o_r0 + 8 * qs;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int d = 8 * j + 2 * t;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(o_r0 + d) =
          pack_bf16(acc[j][0] / d0, acc[j][1] / d0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(o_r1 + d) =
          pack_bf16(acc[j][2] / d1, acc[j][3] / d1);
  }
}

// ---------------------------------------------------------------- launch

template <int D>
void launch_mma(const void* q, const void* k, const void* v, void* o, int B,
                int S, int T_len, int H, int KV, int causal,
                cudaStream_t stream) {
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  flash_attention_mma_kernel<D><<<grid, kMmaThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      S, T_len, H, KV, causal, 1.f / sqrtf(static_cast<float>(D)));
}

template <int D>
void launch(const void* q, const void* k, const void* v, void* o, int B,
            int S, int T_len, int H, int KV, int causal, cudaStream_t stream) {
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  flash_attention_kernel<D><<<grid, Shape<D>::kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, T_len, H, KV,
      causal, 1.f / sqrtf(static_cast<float>(D)));
}

int launch_fp32(const void* q, const void* k, const void* v, void* o,
                int B, int S, int T_len, int H, int KV, int D, int causal,
                cudaStream_t s) {
  switch (D) {
    case 8: launch<8>(q, k, v, o, B, S, T_len, H, KV, causal, s);
      break;
    case 16: launch<16>(q, k, v, o, B, S, T_len, H, KV, causal, s);
      break;
    case 32: launch<32>(q, k, v, o, B, S, T_len, H, KV, causal, s);
      break;
    case 64: launch<64>(q, k, v, o, B, S, T_len, H, KV, causal, s);
      break;
    case 128: launch<128>(q, k, v, o, B, S, T_len, H, KV, causal, s);
      break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

int launch_bf16(const void* q, const void* k, const void* v, void* o,
                int B, int S, int T_len, int H, int KV, int D, int causal,
                cudaStream_t s) {
  switch (D) {
    case 8: launch_mma<8>(q, k, v, o, B, S, T_len, H, KV, causal, s); break;
    case 16: launch_mma<16>(q, k, v, o, B, S, T_len, H, KV, causal, s); break;
    case 32: launch_mma<32>(q, k, v, o, B, S, T_len, H, KV, causal, s); break;
    case 64: launch_mma<64>(q, k, v, o, B, S, T_len, H, KV, causal, s); break;
    case 128: launch_mma<128>(q, k, v, o, B, S, T_len, H, KV, causal, s);
      break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o). D in {8, 16, 32, 64,
// 128}: every head dimension of the port's configurations.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int T_len, int H, int KV, int D,
                                      int causal, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || T_len <= 0 || H <= 0 || KV <= 0 || H % KV ||
      H > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  int err;
  if (dtype == 0) {
    err = launch_fp32(q, k, v, o, B, S, T_len, H, KV, D, causal, s);
  } else if (dtype == 1) {
    err = launch_bf16(q, k, v, o, B, S, T_len, H, KV, D, causal, s);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
