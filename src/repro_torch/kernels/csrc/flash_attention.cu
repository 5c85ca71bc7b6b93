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
// 4*D*H*B*S*(S+1)/2 = 68.7 GFLOP: 0.0695 ms at the 989 TFLOP/s of bf16
// tensor cores, 1.03 ms at the 67 TFLOP/s of fp32 FMAs, against 84 MB of
// bf16 operands and result (0.025 ms at 3.35 TB/s). Three routes:
//
// - bf16 at D = 64 and 128 (every full-width configuration): wgmma with
//   operands loaded by TMA, warp-specialised (below);
// - bf16 at D = 8, 16, 32 (the smoke widths): mma.sync m16n8k16 with
//   fp32 accumulation, K and V staged through registers (the first
//   port's tensor-core body);
// - fp32: every multiply-add on the fp32 pipes (no TF32), bounded by the
//   1.03 ms.
// Every route keeps scores, the online softmax and the accumulator in
// fp32; the bf16 routes round p to bf16 for the PV product (the TPU
// kernel keeps p in fp32: at most 2^-8 relative on each weight, the size
// of the bf16 output's own rounding).
//
// bf16 design at D = 64, 128 (what the first port's mma.sync body lost
// to, and what this one does about it):
// - Rate: QK^T is wgmma m64n128k16 with Q and K K-major in shared memory
//   (128-byte swizzle); PV is wgmma m64n64k16 per 64 columns of D with P
//   in registers (the S accumulators packed to bf16 pairs are the A
//   fragments) and V read N-major with the transpose bit, so V is never
//   transposed.
// - Loads: one CTA of three warpgroups for 128 query rows of one (head,
//   batch row). One producer thread keeps a ring of K/V stages (3 at
//   D = 64, 2 at D = 128; 128 keys each) in flight with TMA
//   (cp.async.bulk.tensor over 4-D maps (D, heads, seq, B), boxes of 64
//   columns, so a D = 128 row is two boxes); each stage completes on a
//   full mbarrier, and the two consumer warpgroups (64 rows each) release
//   it on an empty one. Keys past T inside a batch row come back as
//   zeros (TMA's fill) and are masked to probability 0. setmaxnreg gives
//   the consumers 240 registers and the producer 24 (the CTA holds 168 a
//   thread at launch; the launch checks that).
// - Overlap: the two consumer warpgroups take turns to issue QK^T
//   (named barriers), so one's softmax runs while the other's products
//   do. (Issuing tile t's QK^T with tile t-1's PV inside a warpgroup, as
//   FlashAttention-3 also does, measured slower here.)
// - Masking: only tiles that cross the diagonal or the T edge evaluate
//   the mask; tiles below the diagonal run without it. A CTA's 128 rows
//   span one 128-key tile, so every key tile it loads reaches both
//   warpgroups' rows and both take the same turns.
// - Softmax: the row max of the raw scores, scaled once; each p is
//   exp2f of one FMA, s * scale * log2(e) - m.
// - Scheduling: blockIdx.z walks the query tiles from the last one, so
//   the CTAs with the most key tiles start in the first wave.
// - Epilogue: acc / max(l, 1e-30), written as bf16 pairs.
// The tensor maps are encoded on the host at each call
// (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so the
// library needs no -lcuda) and passed as __grid_constant__ parameters,
// which a CUDA graph captures by value. q, k and v must be 16-byte
// aligned (TMA); the wrapper checks.
//
// bf16 design at D <= 32. One CTA of four warps per (query tile of 64
// rows, head, batch row); warp w owns rows 16w..16w+15, holds its q rows
// as mma A fragments in registers for the whole key loop, and keeps its
// scores, row max, row sum and 16 x D fp32 accumulator in mma C
// fragments. Per key tile of 64, K is staged in shared memory row-major
// and V transposed, rows padded by 16 bytes; the score fragments become
// the A fragments of PV in registers.
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
// Every route: causal attention stops the key loop after the tile
// holding the CTA's last query (the TPU kernel's skip of whole blocks
// above the diagonal) and masks inside it with -1e30, as the TPU kernel
// does. Ragged S and T edges are masked (keys past T get probability 0;
// rows past S are computed and not stored), though the model only sends
// multiples of 128. The result is acc / max(l, 1e-30), written in the
// operands' type.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cuda.h>
#include <cudaTypedefs.h>

#include "hopper.cuh"
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

// ------------------------------------------- bf16 route, D in {64, 128}

// One CTA: 128 query rows of one (head, batch row). Warpgroups 0 and 1
// consume (64 rows each), warpgroup 2 produces (one thread issues TMA).
constexpr int kWgRows = 64;
constexpr int kCtaRows = 2 * kWgRows;
constexpr int kWgKeys = 128;               // keys per tile (BK)
constexpr int kWgThreads = 384;
constexpr int kConsumerRegs = 240;         // setmaxnreg: 2 x 128 x 240 +
constexpr int kProducerRegs = 24;          // 128 x 24 = 384 x 168
constexpr int kLaunchRegs = 168;           // 65536 / 384, rounded to 8
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct WgPlan {
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kChunks = D / 64;                 // 128-byte columns
  static constexpr int kQChunk = kCtaRows * 128;         // bytes per column
  static constexpr int kKvChunk = kWgKeys * 128;
  static constexpr int kQBytes = kChunks * kQChunk;
  static constexpr int kStageBytes = 2 * kChunks * kKvChunk;   // K and V
  static constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
  // + the barriers, + 1024 to align the base to the swizzle atom
  static constexpr int kSmemBytes = kBarOffset + 8 * (2 * kStages + 1) +
                                    1024;
};

static_assert(kCtaRows == kWgKeys,
              "a CTA's rows must span one key tile (the warpgroups' turns)");
constexpr int kSmemLimit = 232448;         // a block's most, H100
static_assert(WgPlan<64>::kSmemBytes <= kSmemLimit &&
                  WgPlan<128>::kSmemBytes <= kSmemLimit,
              "the K/V ring must fit one block's shared memory");

using repro::mbar_arrive;
using repro::mbar_expect_tx;
using repro::mbar_init;
using repro::mbar_wait;
using repro::named_arrive;
using repro::named_sync;
using repro::sw128_desc;
using repro::tma_load_4d;

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             __nv_bfloat16* __restrict__ o, int S, int T_len,
                             int H, int KV, int causal, float scale_log2) {
  using P = WgPlan<D>;
  constexpr int BK = kWgKeys;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_s = smem;
  auto k_s = [&](int stage, int c) {
    return smem + P::kQBytes + stage * P::kStageBytes + c * P::kKvChunk;
  };
  auto v_s = [&](int stage, int c) {
    return k_s(stage, c) + P::kChunks * P::kKvChunk;
  };
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kBarOffset);
  uint64_t* empty = full + P::kStages;
  uint64_t* q_full = empty + P::kStages;

  // longest first: blockIdx.z walks the query tiles from the last one
  const int n_qt = (S + kCtaRows - 1) / kCtaRows;
  const int q0 = (n_qt - 1 - blockIdx.z) * kCtaRows;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (H / KV);
  const int n_kt = (T_len + BK - 1) / BK;
  const int n_tiles =
      causal ? min(n_kt, (min(q0 + kCtaRows, S) - 1) / BK + 1) : n_kt;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);           // lane 0 of each consumer warp
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    // ------------------------------------------------------- producer
    repro::setmaxnreg_dec<kProducerRegs>();
    if (tid == 256) {
      mbar_expect_tx(q_full, P::kQBytes);
      for (int c = 0; c < P::kChunks; ++c)
        tma_load_4d(q_s + c * P::kQChunk, &tq, q_full, 64 * c, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int stage = t % P::kStages, round = t / P::kStages;
        if (round > 0) mbar_wait(&empty[stage], (round - 1) & 1);
        mbar_expect_tx(&full[stage], P::kStageBytes);
        for (int c = 0; c < P::kChunks; ++c) {
          tma_load_4d(k_s(stage, c), &tk, &full[stage], 64 * c, kvh, t * BK,
                      b);
          tma_load_4d(v_s(stage, c), &tv, &full[stage], 64 * c, kvh, t * BK,
                      b);
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    repro::setmaxnreg_inc<kConsumerRegs>();
    const int lane = tid % 32, warp = (tid / 32) % 4;
    const int g = lane / 4, t4 = lane % 4;
    const int r_lo = q0 + kWgRows * wg;          // this warpgroup's rows
    const int r0 = r_lo + 16 * warp + g, r1 = r0 + 8;   // this thread's
    // tiles below n_full see every key of every row of this warpgroup
    const int n_full = (causal ? min(r_lo + 1, T_len) : T_len) / BK;

    float acc[P::kChunks][32];
#pragma unroll
    for (int c = 0; c < P::kChunks; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    mbar_wait(q_full, 0);

    // The two warpgroups take turns to issue QK^T (named barriers 1 and
    // 2), so one's softmax runs while the other's products do.
    if (wg == 1) named_arrive(1);        // warpgroup 0 issues first
    for (int t = 0; t < n_tiles; ++t) {
      const int stage = t % P::kStages, round = t / P::kStages;
      mbar_wait(&full[stage], round & 1);
      // S = Q K^T over D in k16 steps, 4 per 128-byte column
      float s[BK / 2];
      named_sync(1 + wg);
      repro::wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k) {
        const int c = k / 4, kk = k % 4;
        repro::wgmma_ss_n128(
            s, sw128_desc(q_s + c * P::kQChunk + wg * kWgRows * 128 +
                          32 * kk),
            sw128_desc(k_s(stage, c) + 32 * kk), k > 0);
      }
      repro::wgmma_commit();
      named_arrive(2 - wg);
      repro::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) repro::reg_fence(s[i]);

      // the mask only where a tile crosses the diagonal or the T edge
      if (t >= n_full) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int key = t * BK + 8 * (i / 4) + 2 * t4 + (i & 1);
          const int row = (i & 2) ? r1 : r0;
          if (key >= T_len) {
            s[i] = __int_as_float(0xff800000);   // -inf: probability 0
          } else if (causal && key > row) {
            s[i] = kNegInf;
          }
        }
      }
      // the online softmax in the log2 domain: the row max of the raw
      // scores, scaled once; p = 2^(s * scale - m) as one FMA and ex2
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int i = 0; i < BK / 2; i += 4) {
        mx0 = fmaxf(mx0, fmaxf(s[i], s[i + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[i + 2], s[i + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off *= 2) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      mx0 = fmaxf(m0, mx0 * scale_log2);
      mx1 = fmaxf(m1, mx1 * scale_log2);
      const float c0 = exp2f(m0 - mx0), c1 = exp2f(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 2; i += 4) {
        s[i] = exp2f(fmaf(s[i], scale_log2, -mx0));
        s[i + 1] = exp2f(fmaf(s[i + 1], scale_log2, -mx0));
        s[i + 2] = exp2f(fmaf(s[i + 2], scale_log2, -mx1));
        s[i + 3] = exp2f(fmaf(s[i + 3], scale_log2, -mx1));
        ps0 += s[i] + s[i + 1];
        ps1 += s[i + 2] + s[i + 3];
      }
      l0 = l0 * c0 + ps0;
      l1 = l1 * c1 + ps1;
#pragma unroll
      for (int c = 0; c < P::kChunks; ++c)
#pragma unroll
        for (int i = 0; i < 32; i += 4) {
          acc[c][i] *= c0; acc[c][i + 1] *= c0;
          acc[c][i + 2] *= c1; acc[c][i + 3] *= c1;
        }

      // O += P V: p packed to bf16 A fragments (16 keys each), V read
      // N-major (keys are rows, D contiguous) with the transpose bit
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        pa[kc][0] = pack_bf16(s[8 * kc], s[8 * kc + 1]);
        pa[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
        pa[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
        pa[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
      }
      repro::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
        for (int c = 0; c < P::kChunks; ++c)
          repro::wgmma_rs_n64_tn(acc[c], pa[kc],
                                 sw128_desc(v_s(stage, c) + kc * 2048));
      repro::wgmma_commit();
      repro::wgmma_wait<0>();
      // the A registers are read asynchronously: keep them live to here
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" :: "r"(pa[kc][e]));
#pragma unroll
      for (int c = 0; c < P::kChunks; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) repro::reg_fence(acc[c][i]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
    }

#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    const size_t qs = static_cast<size_t>(H) * D;
    __nv_bfloat16* o_r0 = o + (static_cast<size_t>(b) * S + r0) * qs +
                          static_cast<size_t>(h) * D;
    __nv_bfloat16* o_r1 = o_r0 + 8 * qs;
#pragma unroll
    for (int c = 0; c < P::kChunks; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = 64 * c + 8 * j + 2 * t4;
        if (r0 < S)
          *reinterpret_cast<uint32_t*>(o_r0 + d) =
              pack_bf16(acc[c][4 * j] / d0, acc[c][4 * j + 1] / d0);
        if (r1 < S)
          *reinterpret_cast<uint32_t*>(o_r1 + d) =
              pack_bf16(acc[c][4 * j + 2] / d1, acc[c][4 * j + 3] / d1);
      }
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


// A 4-D map over a contiguous bf16 (B, L, heads, D) tensor, innermost
// first (D, heads, L, B), with boxes of 64 columns (128 bytes) x `rows`
// positions of one head and batch row, 128-byte swizzled. Positions past
// L inside a batch row come back as zeros.
bool encode_map(CUtensorMap* map, const void* base, int B, int L, int heads,
                int D, int rows) {
  auto fn = repro::tensor_map_encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(heads),
                              cuuint64_t(L), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(D) * 2,
                                 cuuint64_t(heads) * D * 2,
                                 cuuint64_t(L) * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, cuuint32_t(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 int B, int S, int T_len, int H, int KV, int causal,
                 cudaStream_t stream) {
  auto kernel = flash_attention_wgmma_kernel<D>;
  static int ready = 0;   // 1: attributes set and checked; -1: refused
  if (ready == 0) {
    cudaFuncAttributes attr;
    ready = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 WgPlan<D>::kSmemBytes) == cudaSuccess &&
                    cudaFuncGetAttributes(&attr, kernel) == cudaSuccess &&
                    attr.numRegs == kLaunchRegs
                ? 1 : -1;
    // setmaxnreg moves registers inside the CTA's allocation: the
    // consumers' 240 fit only if the launch holds 168 a thread
  }
  if (ready < 0) return cudaErrorInvalidConfiguration;
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, q, B, S, H, D, kCtaRows) ||
      !encode_map(&tk, k, B, T_len, KV, D, kWgKeys) ||
      !encode_map(&tv, v, B, T_len, KV, D, kWgKeys))
    return cudaErrorInvalidValue;
  const dim3 grid(H, B, (S + kCtaRows - 1) / kCtaRows);
  kernel<<<grid, kWgThreads, WgPlan<D>::kSmemBytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, T_len, H, KV, causal,
      kLog2e / sqrtf(static_cast<float>(D)));
  return cudaSuccess;
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
    case 64: return launch_wgmma<64>(q, k, v, o, B, S, T_len, H, KV, causal,
                                     s);
    case 128: return launch_wgmma<128>(q, k, v, o, B, S, T_len, H, KV,
                                       causal, s);
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
