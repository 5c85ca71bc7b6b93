// Causal chunk attention through the paged KV cache's block table: a
// C-token prompt chunk at per-row offset q_off attends over the row's
// prior K/V and its own. Replaces the TPU kernel
// repro/kernels/flash_prefill/kernel.py (_fp_kernel, launched by
// flash_prefill's pallas_call). Semantics: block_table_attention.cuh.
//
// What bounds it on the H100: at the serving chunk (C = 128, G = 4,
// hd 64) one (row, KV head) does 4 * C * G * hd FLOPs per K/V position
// it reads, about 512 FLOPs per K/V byte in bf16: above the card's ~295
// FLOPs per byte, so with the operands read once the floor is the
// tensor cores' rate, with the bytes close behind (at short offsets the
// q/out bytes dominate and the bound is bytes). Either way the products
// belong on the tensor cores, not on the CUDA cores through shared
// memory.
//
// bf16 route (the model's compute type):
// - CTA shape. One CTA of 4 warps holds 64 c-major query rows of one
//   (row b, KV head); grid (B, KV, ceil(C * G / 64)). Warp w owns rows
//   16w..16w+15 and keeps them as mma.sync m16n8k16 A fragments in
//   registers for the whole key loop, so each K/V tile it loads serves
//   64 query rows (every head of the group, 64 / G chunk positions).
// - Key tiles. The CTA walks its row's positions in tiles of 64 keys,
//   loaded through the block table with one 16-byte cp.async per 16
//   bytes of a position row (128 B at hd 64, 256 B at hd 128); a tile
//   spans 64 / block table entries, for any block size. Positions past
//   the CTA's last visible one are zero-filled by the copy, not read.
// - Double buffering. Two stages: tile j + 1 is in flight while tile j
//   is multiplied; one barrier after the copy lands and one before its
//   stage is refilled.
// - Fragments. K and V stay row-major in shared memory, each row padded
//   by 16 bytes so the eight rows of an ldmatrix hit eight different
//   bank groups. QK^T takes its B fragments with ldmatrix, PV with
//   ldmatrix.trans: the copy lands tiles without a register pass.
// - Softmax and masks. Scores, the online softmax and the accumulator
//   stay fp32 in the mma C fragments; the scale, with log2(e) folded in
//   for exp2f, is applied to the fp32 scores (q is never rounded after
//   scaling), and p is rounded to bf16 for PV, as flash_attention.cu's
//   bf16 route does (at most 2^-8 of sum_j p_j |v_j|). Row r sees
//   positions up to q_off[b] + r / G; the -1e30 mask runs only in tiles
//   that cross the CTA's first row's limit, and the loop stops after
//   the tile holding the CTA's last visible position, so later blocks
//   are never read.
// - Shared memory: 2 stages x (K, V) x 64 x (hd + 8) x 2 bytes, 36 KB at
//   hd 64 and 68 KB at hd 128 (dynamic, above the 48 KB default). A
//   third stage gained nothing on the H100; a power-of-two block turning
//   the table lookup's division into a shift, exp2f, and a 128-register
//   cap at hd 64 (4 CTAs an SM) each did.
//
// fp32 route (the serving parity path; TF32 would change the numbers):
// the first port's body, kept as it was but for the shared table lookup
// (kv_offset). One CTA per 16 c-major rows of
// a (row, KV head); tiles of 32 positions staged in shared memory as
// fp32, one warp per query row with a lane per key, the accumulator in
// registers, every multiply on the fp32 pipes.
//
// A head range (both routes). On a serving mesh whose model axis splits
// the query heads and not the K/V heads, q holds H of a model's n_heads
// query heads, [q_head0, q_head0 + H), against every K/V head of the
// pools (groups of G = n_heads / KV). The grid's second dim then walks
// the K/V heads the range touches; a CTA's c-major rows are the chunk
// positions times the range's query heads of its K/V head (cnt of them;
// local head j reads K/V head (q_head0 + j) / G, and a range may
// straddle two K/V heads), and a CTA past its K/V head's last row exits.
// With q_head0 = 0 and n_heads = H, cnt = G and the mapping is the plain
// one, with the same arithmetic.
#include "block_table_attention.cuh"
#include "mma_bf16.cuh"

namespace repro {
namespace {

// ------------------------------------------------------------ bf16 route

constexpr int kRows = 64;         // query rows per CTA, 16 per warp
constexpr int kKeys = 64;         // key positions per tile
constexpr int kMmaThreads = 128;
constexpr int kPad = 8;           // bf16 elements (16 bytes) per smem row
constexpr int kStages = 2;        // K/V tiles in flight
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
constexpr int mma_smem() {
  return kStages * 2 * kKeys * (HD + kPad) * (int)sizeof(__nv_bfloat16);
}

template <int HD>
// hd 64: at most 128 registers, 4 CTAs an SM (512 CTAs at the serving
// shapes fit in one wave); hd 128 keeps its registers (a cap spills).
__global__ void __launch_bounds__(kMmaThreads, HD == 64 ? 4 : 1)
    prefill_mma_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_pool,
    const __nv_bfloat16* __restrict__ v_pool, const int* __restrict__ table,
    const int* __restrict__ q_off, __nv_bfloat16* __restrict__ out, int C,
    int H, int KV, int G, int q_head0, BlockSize bs, int bpr,
    float scale) {
  constexpr int RS = HD + kPad;  // shared row stride, elements
  constexpr int KC = HD / 16;    // k16 chunks of a q row
  constexpr int NT = kKeys / 8;  // n8 tiles of a score row
  constexpr int DT = HD / 8;     // n8 tiles of an output row
  constexpr int CPR = HD / 8;    // 16-byte copies per position row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][64][RS]
  __nv_bfloat16* vs = ks + kStages * kKeys * RS;

  const int b = blockIdx.x;
  const int h = q_head0 / G + blockIdx.y;      // this CTA's K/V head
  const int j0 = max(0, h * G - q_head0);      // its first local q head
  const int cnt = min(H, (h + 1) * G - q_head0) - j0;   // and their count
  const int rows = C * cnt;
  const int row0 = blockIdx.z * kRows;
  if (row0 >= rows) return;  // past this K/V head's rows
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int T_len = bpr * bs.size;
  const int off = q_off[b];
  const int ra = row0 + 16 * warp + g, rb = ra + 8;  // this thread's rows
  const int lim_a = min(off + ra / cnt, T_len - 1);
  const int lim_b = min(off + rb / cnt, T_len - 1);
  const int lim_lo = min(off + row0 / cnt, T_len - 1);  // the CTA's first row
  // one past the CTA's last visible position
  const int n_pos =
      min(off + (min(row0 + kRows, rows) - 1) / cnt + 1, T_len);
  const int* trow = table + (long long)b * bpr;

  auto q_row = [&](int r) -> const __nv_bfloat16* {
    return r < rows
               ? q + ((long long)(b * C + r / cnt) * H + j0 + r % cnt) * HD
               : nullptr;
  };
  const __nv_bfloat16* qra = q_row(ra);
  const __nv_bfloat16* qrb = q_row(rb);
  uint32_t qa[KC][4];
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    const int d = 16 * c + 2 * t;
    qa[c][0] = qra ? ld32(qra + d) : 0u;
    qa[c][1] = qrb ? ld32(qrb + d) : 0u;
    qa[c][2] = qra ? ld32(qra + d + 8) : 0u;
    qa[c][3] = qrb ? ld32(qrb + d + 8) : 0u;
  }

  auto load_tile = [&](int tile, int stage) {
    const int k0 = tile * kKeys;
    __nv_bfloat16* kd = ks + stage * kKeys * RS;
    __nv_bfloat16* vd = vs + stage * kKeys * RS;
#pragma unroll
    for (int i = 0; i < kKeys * CPR / kMmaThreads; ++i) {
      const int e = tid + i * kMmaThreads;
      const int j = e / CPR, c8 = 8 * (e % CPR);
      const int pos = k0 + j;
      const bool valid = pos < n_pos;
      const long long o =
          valid ? kv_offset(trow, pos, bs, KV, h, HD) + c8 : 0;
      cp_async16(kd + j * RS + c8, k_pool + o, valid);
      cp_async16(vd + j * RS + c8, v_pool + o, valid);
    }
    cp_async_commit();
  };

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // per-thread l

  const int n_tiles = (n_pos + kKeys - 1) / kKeys;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) {
      load_tile(t, t);
    } else {
      cp_async_commit();
    }
  }
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile % kStages;
    const int next = tile + kStages - 1;
    if (next < n_tiles) {
      load_tile(next, next % kStages);
    } else {
      cp_async_commit();  // an empty group keeps the count uniform
    }
    cp_async_wait<kStages - 1>();
    __syncthreads();  // tile `tile` has landed for every thread
    const __nv_bfloat16* kt = ks + stage * kKeys * RS;
    const __nv_bfloat16* vt = vs + stage * kKeys * RS;

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int c = 0; c < KC; c += 2) {
        // matrices: keys 8n.., dims 16c, 16c + 8, 16c + 16, 16c + 24
        uint32_t kb[4];
        ldmatrix_x4(kb, kt + (8 * n + (lane & 7)) * RS + 16 * c +
                            8 * (lane >> 3));
        mma_bf16(s[n], qa[c], kb[0], kb[1]);
        mma_bf16(s[n], qa[c + 1], kb[2], kb[3]);
      }
    }
    const int k0 = tile * kKeys;
    const bool edge = k0 + kKeys - 1 > lim_lo;
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;  // in log2 units: scale carries log2(e)
        if (edge && k0 + 8 * n + 2 * t + (e & 1) > (e < 2 ? lim_a : lim_b))
          x = NEG_INF;
        s[n][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int o = 1; o < 4; o *= 2) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = exp2f(s[n][0] - mn0);
      s[n][1] = exp2f(s[n][1] - mn0);
      s[n][2] = exp2f(s[n][2] - mn1);
      s[n][3] = exp2f(s[n][3] - mn1);
      ps0 += s[n][0] + s[n][1];
      ps1 += s[n][2] + s[n][3];
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][0] *= c0;
      acc[j][1] *= c0;
      acc[j][2] *= c1;
      acc[j][3] *= c1;
    }
#pragma unroll
    for (int kc = 0; kc < kKeys / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        // matrices: keys 16kc.. and 16kc + 8.., dims 8j and 8j + 8
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vt + (16 * kc + (lane & 7) +
                                    8 * ((lane >> 3) & 1)) * RS +
                                  8 * j + 8 * (lane >> 4));
        mma_bf16(acc[j], pa, vb[0], vb[1]);
        mma_bf16(acc[j + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

#pragma unroll
  for (int o = 1; o < 4; o *= 2) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* oa =
      qra ? out + (qra - q) : nullptr;  // out has q's layout
  __nv_bfloat16* ob = qrb ? out + (qrb - q) : nullptr;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int d = 8 * j + 2 * t;
    if (oa)
      *reinterpret_cast<uint32_t*>(oa + d) =
          pack_bf16(acc[j][0] / d0, acc[j][1] / d0);
    if (ob)
      *reinterpret_cast<uint32_t*>(ob + d) =
          pack_bf16(acc[j][2] / d1, acc[j][3] / d1);
  }
}

template <int HD>
int launch_mma(const void* q, const void* k_pool, const void* v_pool,
               const void* table, const void* q_off, void* out, int B, int C,
               int H, int KV, int G, int q_head0, int block, int bpr,
               cudaStream_t s) {
  constexpr int smem = mma_smem<HD>();
  static bool raised = false;
  const int err = allow_smem(prefill_mma_kernel<HD>, smem, raised);
  if (err != 0) return err;
  const int n_kv = (q_head0 + H - 1) / G - q_head0 / G + 1;
  const int cover = G < H ? G : H;
  const dim3 grid(B, n_kv, (C * cover + kRows - 1) / kRows);
  prefill_mma_kernel<HD><<<grid, kMmaThreads, smem, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pool,
      (const __nv_bfloat16*)v_pool, (const int*)table, (const int*)q_off,
      (__nv_bfloat16*)out, C, H, KV, G, q_head0, BlockSize::of(block), bpr,
      kLog2e / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ fp32 route

constexpr int TT = 32;   // key positions per tile: one lane each
constexpr int FT = 128;  // threads per CTA
constexpr int RT = 16;   // query rows per CTA

template <int HD>
__global__ void __launch_bounds__(FT) prefill_fp32_kernel(
    const float* __restrict__ q, const float* __restrict__ k_pool,
    const float* __restrict__ v_pool, const int* __restrict__ table,
    const int* __restrict__ q_off, float* __restrict__ out, int C, int H,
    int KV, int G, int q_head0, BlockSize bs, int bpr, float scale) {
  static_assert((RT * HD) % FT == 0, "accumulator split");
  constexpr int PER = RT * HD / FT;
  constexpr int NW = FT / 32;

  const int b = blockIdx.x;
  const int h = q_head0 / G + blockIdx.y;      // this CTA's K/V head
  const int j0 = max(0, h * G - q_head0);      // its first local q head
  const int cnt = min(H, (h + 1) * G - q_head0) - j0;   // and their count
  const int r0 = blockIdx.z * RT;
  const int nr = min(RT, C * cnt - r0);
  if (nr <= 0) return;  // past this K/V head's rows
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  __shared__ float q_s[RT][HD];
  __shared__ float k_s[TT][HD + 1];  // +1: lanes read distinct banks
  __shared__ float v_s[TT][HD];
  __shared__ float p_s[RT][TT];
  __shared__ float m_s[RT], l_s[RT], corr_s[RT];
  __shared__ long long base_s[TT];

  const int off = q_off[b];
  // one past the last key position any row of this tile sees
  const int n_pos = min(off + (r0 + nr - 1) / cnt + 1, bpr * bs.size);

  for (int i = tid; i < RT * HD; i += FT) {
    const int r = i / HD, d = i % HD;
    float x = 0.f;
    if (r < nr) {
      const int c = (r0 + r) / cnt, g = (r0 + r) % cnt;
      x = q[((long long)(b * C + c) * H + j0 + g) * HD + d] * scale;
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
      base_s[tid] = pos < n_pos ? kv_offset(table + (long long)b * bpr, pos,
                                            bs, KV, h, HD)
                                : -1;
    }
    __syncthreads();
    for (int i = tid; i < TT * HD; i += FT) {
      const int t = i / HD, d = i % HD;
      const long long base = base_s[t];
      float kx = 0.f, vx = 0.f;
      if (base >= 0) {
        kx = k_pool[base + d];
        vx = v_pool[base + d];
      }
      k_s[t][d] = kx;
      v_s[t][d] = vx;
    }
    __syncthreads();

    for (int r = warp; r < RT; r += NW) {
      const int pos = t0 + lane;
      float s = NEG_INF;
      if (r < nr && pos < n_pos && pos <= off + (r0 + r) / cnt) {
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
      const int i = tid + e * FT;
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
    const int i = tid + e * FT;
    const int r = i / HD, d = i % HD;
    if (r < nr) {
      const int c = (r0 + r) / cnt, g = (r0 + r) % cnt;
      out[((long long)(b * C + c) * H + j0 + g) * HD + d] =
          acc[e] / fmaxf(l_s[r], 1e-30f);
    }
  }
}

template <int HD>
int launch_fp32(const void* q, const void* k_pool, const void* v_pool,
                const void* table, const void* q_off, void* out, int B,
                int C, int H, int KV, int G, int q_head0, int block, int bpr,
                cudaStream_t s) {
  const int n_kv = (q_head0 + H - 1) / G - q_head0 / G + 1;
  const int cover = G < H ? G : H;
  const dim3 grid(B, n_kv, (C * cover + RT - 1) / RT);
  prefill_fp32_kernel<HD><<<grid, FT, 0, s>>>(
      (const float*)q, (const float*)k_pool, (const float*)v_pool,
      (const int*)table, (const int*)q_off, (float*)out, C, H, KV, G,
      q_head0, BlockSize::of(block), bpr, 1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro

// dtype: 0 = float32 (fp32 route), 1 = bfloat16 (tensor cores); hd 64
// or 128. q holds the H query heads [q_head0, q_head0 + H) of n_heads
// (n_heads = H, q_head0 = 0: all of them). Returns the launch status.
extern "C" int flash_prefill_launch(const void* q, const void* k_pool,
                                    const void* v_pool, const void* table,
                                    const void* q_off, void* out, int B,
                                    int C, int H, int KV, int hd, int block,
                                    int bpr, int n_heads, int q_head0,
                                    int dtype, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || KV <= 0 || n_heads % KV != 0 ||
      q_head0 < 0 || q_head0 + H > n_heads || block <= 0 || bpr <= 0)
    return (int)cudaErrorInvalidValue;
  const int G = n_heads / KV;
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_LAUNCH(route, HDV)                                          \
  return repro::route<HDV>(q, k_pool, v_pool, table, q_off, out, B, C, H, \
                           KV, G, q_head0, block, bpr, s)
  if (dtype == 0 && hd == 64) REPRO_LAUNCH(launch_fp32, 64);
  if (dtype == 0 && hd == 128) REPRO_LAUNCH(launch_fp32, 128);
  if (dtype == 1 && hd == 64) REPRO_LAUNCH(launch_mma, 64);
  if (dtype == 1 && hd == 128) REPRO_LAUNCH(launch_mma, 128);
#undef REPRO_LAUNCH
  return (int)cudaErrorInvalidValue;
}
