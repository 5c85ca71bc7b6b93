// Single-token GQA decode attention through the paged KV cache's block
// table, split over positions (flash-decoding). Replaces the TPU kernel
// repro/kernels/paged_attention/kernel.py (_pa_kernel, launched by
// paged_attention's pallas_call). Semantics: block_table_attention.cuh.
//
// What bounds it on the H100: bytes. Each (row, KV head) reads cur_len
// positions of K and V once and does 4 * G * hd FLOPs per position, about
// G FLOPs per byte in bf16, far below the ~295 FLOPs per byte at which the
// tensor cores would become the limit. The floor is the K/V bytes over
// the 3.35 TB/s of HBM; the work stays on the CUDA cores and the design is
// about moving those bytes at the card's rate:
//
// - Filling the card. A (row, KV head) pair holds too few query rows to
//   fill an SM (8 rows x 8 KV heads is 64 pairs for 132 SMs), so each
//   row's positions are split into partitions of kSplit = 64: the grid is
//   (B, KV, n_splits x row tiles), n_splits = ceil(bpr * block / 64). The
//   split count comes from the table's width alone, never from cur_len,
//   which lives on the device (reading it would cost the host a sync per
//   launch). The wrapper's split_plan makes this plan; the entry checks
//   it and launches with it. A CTA whose partition starts at or past its
//   row's cur_len writes an empty partial and exits.
// - Wide loads, all in flight. A position's K row (and V row) is read by
//   hd * elt / 16 lanes with one 16-byte cp.async each: 8 lanes at hd 64
//   in bf16, so a warp covers 4 positions. Every copy of a partition is
//   issued up front into shared memory, in two commit groups: the first
//   half is multiplied while the second is in flight. A lane reads back
//   only the slices it copied itself, so no barrier stands between the
//   copies and the math.
// - No idle rows. A CTA holds NR in {1, 2, 4, 8} query rows, the
//   smallest that covers G (G > 8 is split over the grid in row tiles of
//   8), and every loop over rows stops at the group's real count: no
//   score or PV is computed for a row past G.
// - Arithmetic. q is held in fp32 registers, scaled in fp32 (each lane its
//   16-byte slice of every row) by log2(e) / sqrt(hd), so scores are in
//   log2 units and the softmax runs on exp2f; partial dots are summed
//   across the lane group with shuffles. Each lane group keeps its own
//   online softmax (m, l, acc) over the positions it reads; groups merge
//   with shuffles, warps through shared memory, and the CTA writes its
//   partial (m, l, unnormalised acc) in fp32 to scratch the wrapper
//   allocates. A power-of-two block turns the table lookup's division
//   into a shift; registers are capped so that the 640 CTAs of the
//   serving shapes run in one wave.
// - Combine. A second launch from the same C entry merges the partials of
//   each (row, head): out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s
//   over the partials with l_s > 0. An empty partial (l = 0, acc unwritten)
//   carries no weight, so a row with cur_len == 0 returns exactly 0. The
//   wrapper counts the two launches as one call.
#include "block_table_attention.cuh"

namespace repro {
namespace {

constexpr int kSplit = 64;       // positions per partition
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;    // threads per partition CTA
constexpr int kWarps = kThreads / 32;

template <typename T, int HD>
struct Lanes {
  static constexpr int kElt = 16 / (int)sizeof(T);   // elements per load
  static constexpr int kLanes = HD / kElt;           // lanes per position
  static constexpr int kGroups = kThreads / kLanes;  // positions per pass
  static constexpr int kPasses = kSplit / kGroups;   // passes per partition
  static_assert(kLanes <= 32 && kPasses % 2 == 0, "lane split");
};

template <typename T, int HD, int NR>
constexpr int split_smem() {
  // K and V staging, reused for the cross-warp merge
  return 2 * kSplit * HD * (int)sizeof(T) > kWarps * NR * (HD + 4) * 4
             ? 2 * kSplit * HD * (int)sizeof(T)
             : kWarps * NR * (HD + 4) * 4;
}

__device__ __forceinline__ void unpack16(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(const uint4& u, float* f,
                                         __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Partials: acc (B, H, n_splits, HD), then (m, l) (B, H, n_splits, 2).
template <typename T, int HD, int NR>
// Registers capped so that 3 CTAs (8 rows) or 5 (fewer) share an SM: at the
// serving shapes 640 CTAs then run in one wave.
__global__ void __launch_bounds__(kThreads, NR == 8 ? 3 : 5)
    decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ table,
    const int* __restrict__ cur_len, float* __restrict__ part, int H,
    int KV, BlockSize bs, int bpr, int n_splits, float scale) {
  using L = Lanes<T, HD>;
  constexpr int E = L::kElt, LP = L::kLanes;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + kSplit * HD;

  const int b = blockIdx.x, h = blockIdx.y;
  const int split = blockIdx.z % n_splits;
  const int G = H / KV;
  const int g0 = (blockIdx.z / n_splits) * NR;
  const int nr = min(NR, G - g0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = tid / LP, li = tid % LP;
  const int p0 = split * kSplit;
  const int* trow = table + (long long)b * bpr;
  const int n = min(kSplit, min(cur_len[b], bpr * bs.size) - p0);

  const long long n_part = (long long)gridDim.x * H * n_splits;
  float* part_ml = part + n_part * HD;
  const long long head0 = (long long)b * H + h * G + g0;

  if (n <= 0) {  // nothing to read: an empty partial
    if (tid < nr) {
      const long long p = (head0 + tid) * n_splits + split;
      part_ml[2 * p] = NEG_INF;
      part_ml[2 * p + 1] = 0.f;
    }
    return;
  }

  // Pass i of this thread reads position grp + i * kGroups, slice li:
  // issue every copy now, in two commit groups.
#pragma unroll
  for (int i = 0; i < L::kPasses; ++i) {
    const int j = grp + i * L::kGroups;
    if (j < n) {
      const long long o = kv_offset(trow, p0 + j, bs, KV, h, HD) + li * E;
      cp_async16(ks + j * HD + li * E, k_pool + o, true);
      cp_async16(vs + j * HD + li * E, v_pool + o, true);
    }
    if (i == L::kPasses / 2 - 1) cp_async_commit();
  }
  cp_async_commit();

  float qf[NR][E], acc[NR][E], m[NR], l[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) qf[r][e] = acc[r][e] = 0.f;
    if (r < nr) {
      unpack16(__ldg(reinterpret_cast<const uint4*>(
                   q + (head0 + r) * HD + li * E)),
               qf[r], T());
#pragma unroll
      for (int e = 0; e < E; ++e) qf[r][e] *= scale;
    }
  }

  auto pass = [&](int i) {
    const int j = grp + i * L::kGroups;
    const bool valid = j < n;
    float kf[E], vf[E];
    if (valid) {
      unpack16(*reinterpret_cast<const uint4*>(ks + j * HD + li * E), kf,
               T());
      unpack16(*reinterpret_cast<const uint4*>(vs + j * HD + li * E), vf,
               T());
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) kf[e] = vf[e] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      if (r >= nr) break;
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) s = fmaf(qf[r][e], kf[e], s);
#pragma unroll
      for (int o = LP / 2; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      if (valid) {
        const float mn = fmaxf(m[r], s);
        const float c = exp2f(m[r] - mn), p = exp2f(s - mn);
        l[r] = fmaf(l[r], c, p);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e] * c);
        m[r] = mn;
      }
    }
  };
  cp_async_wait<1>();
#pragma unroll
  for (int i = 0; i < L::kPasses / 2; ++i) pass(i);
  cp_async_wait<0>();
#pragma unroll
  for (int i = L::kPasses / 2; i < L::kPasses; ++i) pass(i);

  // merge the lane groups of a warp (an empty group: m = -1e30, l = 0)
#pragma unroll
  for (int o = LP; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      if (r >= nr) break;
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float mn = fmaxf(m[r], mo);
      const float a = exp2f(m[r] - mn), c = exp2f(mo - mn);
      l[r] = l[r] * a + lo * c;
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[r][e] = acc[r][e] * a +
                    __shfl_xor_sync(0xffffffffu, acc[r][e], o) * c;
      m[r] = mn;
    }
  }

  // merge the warps through shared memory: [warp][row][HD + 4]
  __syncthreads();  // every lane is done with its staged slices
  float* red = reinterpret_cast<float*>(smem);
  if (lane < LP) {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      if (r >= nr) break;
      float* w = red + (warp * NR + r) * (HD + 4);
#pragma unroll
      for (int e = 0; e < E; e += 4)
        *reinterpret_cast<float4*>(w + li * E + e) =
            make_float4(acc[r][e], acc[r][e + 1], acc[r][e + 2],
                        acc[r][e + 3]);
      if (li == 0) {
        w[HD] = m[r];
        w[HD + 1] = l[r];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < nr * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      M = fmaxf(M, red[(w * NR + r) * (HD + 4) + HD]);
    float a = 0.f, ls = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* x = red + (w * NR + r) * (HD + 4);
      const float c = exp2f(x[HD] - M);
      a = fmaf(c, x[d], a);
      ls = fmaf(c, x[HD + 1], ls);
    }
    const long long p = (head0 + r) * n_splits + split;
    part[p * HD + d] = a;
    if (d == 0) {
      part_ml[2 * p] = M;
      part_ml[2 * p + 1] = ls;
    }
  }
}

// One CTA per (row, head), one thread per dim.
template <typename T, int HD>
__global__ void __launch_bounds__(HD) decode_combine_kernel(
    const float* __restrict__ part, T* __restrict__ out, int n_heads,
    int n_splits) {
  const int row = blockIdx.x;  // b * H + head
  const int d = threadIdx.x;
  const float* acc = part + (long long)row * n_splits * HD;
  const float* ml =
      part + (long long)n_heads * n_splits * HD + (long long)row * n_splits * 2;
  float M = NEG_INF;
  for (int s = 0; s < n_splits; ++s)
    if (ml[2 * s + 1] > 0.f) M = fmaxf(M, ml[2 * s]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float l = ml[2 * s + 1];
    if (l > 0.f) {
      const float w = exp2f(ml[2 * s] - M);
      num = fmaf(w, acc[s * HD + d], num);
      den = fmaf(w, l, den);
    }
  }
  out[(long long)row * HD + d] = from_f<T>(num / fmaxf(den, 1e-30f));
}

template <typename T, int HD, int NR>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* table, const void* cur_len, void* out, void* part,
           int B, int H, int KV, int block, int bpr, int n_splits,
           int row_tiles, cudaStream_t s) {
  constexpr int smem = split_smem<T, HD, NR>();
  static bool raised = false;
  int err = allow_smem(decode_split_kernel<T, HD, NR>, smem, raised);
  if (err != 0) return err;
  const dim3 grid(B, KV, n_splits * row_tiles);
  decode_split_kernel<T, HD, NR><<<grid, kThreads, smem, s>>>(
      (const T*)q, (const T*)k_pool, (const T*)v_pool, (const int*)table,
      (const int*)cur_len, (float*)part, H, KV, BlockSize::of(block), bpr,
      n_splits, kLog2e / sqrtf((float)HD));
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  decode_combine_kernel<T, HD><<<B * H, HD, 0, s>>>((const float*)part,
                                                     (T*)out, B * H,
                                                     n_splits);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_rows(const void* q, const void* k_pool, const void* v_pool,
                const void* table, const void* cur_len, void* out,
                void* part, int B, int H, int KV, int block, int bpr,
                int n_splits, int rows, int row_tiles, cudaStream_t s) {
#define REPRO_ROWS(NR)                                                     \
  return launch<T, HD, NR>(q, k_pool, v_pool, table, cur_len, out, part, \
                           B, H, KV, block, bpr, n_splits, row_tiles, s)
  if (rows == 1) REPRO_ROWS(1);
  if (rows == 2) REPRO_ROWS(2);
  if (rows == 4) REPRO_ROWS(4);
  if (rows == 8) REPRO_ROWS(8);
#undef REPRO_ROWS
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro

// The launch plan is the wrapper's split_plan: split must be 64 and
// n_splits ceil(bpr * block / 64); rows (1, 2, 4 or 8 query rows a CTA)
// times row_tiles must cover G = H / KV with no tile left empty; part is
// fp32 scratch of B * H * n_splits * (hd + 2) elements. Returns the first
// launch error, else 0.
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool, const void* table,
                                      const void* cur_len, void* out,
                                      void* part, int B, int H, int KV,
                                      int hd, int block, int bpr,
                                      int split, int n_splits, int rows,
                                      int row_tiles, int dtype,
                                      void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || block <= 0 || bpr <= 0 ||
      rows <= 0 || row_tiles <= 0 || split != repro::kSplit ||
      n_splits != (bpr * block + repro::kSplit - 1) / repro::kSplit ||
      rows * (row_tiles - 1) >= H / KV || rows * row_tiles < H / KV ||
      (long long)n_splits * row_tiles > 65535 || KV > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_LAUNCH(T, HDV)                                               \
  return repro::launch_rows<T, HDV>(q, k_pool, v_pool, table, cur_len,    \
                                    out, part, B, H, KV, block, bpr,      \
                                    n_splits, rows, row_tiles, s)
  if (dtype == 0 && hd == 64) REPRO_LAUNCH(float, 64);
  if (dtype == 0 && hd == 128) REPRO_LAUNCH(float, 128);
  if (dtype == 1 && hd == 64) REPRO_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && hd == 128) REPRO_LAUNCH(__nv_bfloat16, 128);
#undef REPRO_LAUNCH
  return (int)cudaErrorInvalidValue;
}
