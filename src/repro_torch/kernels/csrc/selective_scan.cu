// Selective scan: the mamba1 recurrence over Q steps,
//   h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t * B_t,   y_t = <h_t, C_t>,
// with the state h carried in (h0) and out (h_out). Replaces the TPU
// kernel repro/kernels/selective_scan/kernel.py (_ss_kernel, launched by
// selective_scan's pallas_call). The caller launches it once over a whole
// prompt; the TPU kernel's chunks exist for its VMEM, which this needs not.
//
// What bounds it on the H100: bytes and the exponentials, nearly equally,
// and the issue slots close behind. Each (row, channel) reads Q values of
// dt and x and writes Q of y (fp32), and reads and writes its N-state
// once: at B=8, Q=128, Di=8192, N=16 that is 110 MB, 0.033 ms at 3.35
// TB/s. It also takes B*Q*Di*N = 1.3e8 exponentials, whose ex2 runs in the
// SFU at 16 results per clock per SM: 0.032 ms at 1.98 GHz.
//
// Design (PERF.md gives the times of the options measured):
// - Staged asynchronous tiles. A CTA owns kChannels channels of one row b.
//   A ring of kStages shared-memory stages holds kSteps steps each of the
//   CTA's dt and x columns and the row's B_ and C_ rows, loaded by TMA
//   through 3-D tensor maps over (Di, Q, B) and (N, Q, B): a box past Q or
//   Di is zero-filled inside its row. A producer warp of its own keeps the
//   ring full: each stage completes on a full mbarrier and is released on
//   an empty one (one arrive a consumer warp), so no CTA-wide barrier sits
//   in the step loop, and the next tiles' loads (up to about 100 KB an SM)
//   stay in flight while the SFU works on this one.
// - One thread a channel: a thread keeps the channel's N states and A's
//   row (pre-scaled) in registers for the whole launch. Splitting the N
//   states over 4 lanes (40 consumer warps an SM, not 16; y summed by
//   shuffle) measured slower: it issues more instructions an element (the
//   shuffles, the per-lane loads of dt and x), and this kernel runs near
//   the SFU's, the issue slots' and the memory's limits at once.
// - y: each step's sum goes to the warp's own y tile in shared memory,
//   which the warp's lane 0 stores by TMA once a tile (two tiles, so a
//   store overlaps the next tile's math). Elements past Q or Di are not
//   stored.
// - Exponentials: A is scaled by log2(e) once, in registers, and each
//   exp(dt * A) is one multiply and one ex2.approx.ftz.f32 (MUFU.EX2, no
//   range reduction; relative error about 2^-22).
// - Order of arithmetic: h and every sum in fp32; every step is the same
//   explicit sequence of rounded multiplies and FMAs (no contraction left
//   to the compiler), sequential in t per (b, d, n). So one launch over S
//   steps equals the chain of launches over S / Q chunks bit for bit: h
//   crosses a chunk boundary through memory in fp32 unchanged.
// - The TPU grid's sequential walk down the chunk becomes the tile loop
//   inside each CTA; channels are independent, so nothing crosses CTAs.
// The tensor maps are encoded on the host at each call and passed as
// __grid_constant__ parameters, which a CUDA graph captures by value.
// Every operand must be 16-byte aligned (TMA, and the 16-byte loads of A
// and h0) and Di a multiple of 4 (the maps' row strides are multiples of
// 16 bytes); the wrapper checks both.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using repro::mbar_arrive;
using repro::mbar_expect_tx;
using repro::mbar_init;
using repro::mbar_wait;

constexpr int kWarps = 8;                 // consumer warps
constexpr int kBlock = 32 * kWarps + 32;  // and the producer warp
constexpr int kChannels = 32 * kWarps;    // of one row, a CTA
constexpr int kSteps = 8;                 // steps a stage
constexpr int kStages = 4;
constexpr int kMinBlocks = 2;  // CTAs an SM: one wave at (8, Q, 8192)
constexpr float kLog2e = 1.4426950408889634f;

template <int N>
struct Smem {
  float dt[kStages][kSteps][kChannels];
  float x[kStages][kSteps][kChannels];
  float b[kStages][kSteps][N];
  float c[kStages][kSteps][N];
  float y[2][kWarps][kSteps][32];
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

// K consecutive floats at p (16-byte aligned), in 16-byte loads.
template <int K>
__device__ __forceinline__ void load_vec(float (&v)[K], const float* p) {
  static_assert(K % 4 == 0, "load_vec");
#pragma unroll
  for (int q = 0; q < K / 4; ++q) {
    const float4 f = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] = f.x;
    v[4 * q + 1] = f.y;
    v[4 * q + 2] = f.z;
    v[4 * q + 3] = f.w;
  }
}

// The same, stored.
template <int K>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[K]) {
  static_assert(K % 4 == 0, "store_vec");
#pragma unroll
  for (int q = 0; q < K / 4; ++q)
    reinterpret_cast<float4*>(p)[q] =
        make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

template <int N>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    selective_scan_kernel(const __grid_constant__ CUtensorMap t_dt,
                          const __grid_constant__ CUtensorMap t_x,
                          const __grid_constant__ CUtensorMap t_b,
                          const __grid_constant__ CUtensorMap t_c,
                          const __grid_constant__ CUtensorMap t_y,
                          const float* __restrict__ A,
                          const float* __restrict__ h0,
                          float* __restrict__ h_out, int Q, int Di) {
  constexpr uint32_t kStageBytes =
      sizeof(float) * kSteps * (2 * kChannels + 2 * N);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<N>& sm = *reinterpret_cast<Smem<N>*>(smem_raw);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = threadIdx.x;                 // channel in the CTA
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  const int d = d0 + c;
  const int dw = d0 + 32 * warp;             // the warp's first
  const bool live = d < Di;
  const int n_tiles = (Q + kSteps - 1) / kSteps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kWarps);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kWarps) {   // the producer: tile k into stage k % kStages
    if (lane == 0)
      for (int k = 0; k < n_tiles; ++k) {
        const int s = k % kStages;
        if (k >= kStages) mbar_wait(&sm.empty[s], (k / kStages - 1) & 1);
        mbar_expect_tx(&sm.full[s], kStageBytes);
        repro::tma_load_3d(sm.dt[s], &t_dt, &sm.full[s], d0, k * kSteps, b);
        repro::tma_load_3d(sm.x[s], &t_x, &sm.full[s], d0, k * kSteps, b);
        repro::tma_load_3d(sm.b[s], &t_b, &sm.full[s], 0, k * kSteps, b);
        repro::tma_load_3d(sm.c[s], &t_c, &sm.full[s], 0, k * kSteps, b);
      }
    return;
  }

  float a2[N] = {}, h[N] = {};
  const size_t state = (static_cast<size_t>(b) * Di + d) * N;
  if (live) {
    load_vec(a2, A + static_cast<size_t>(d) * N);
    load_vec(h, h0 + state);
#pragma unroll
    for (int i = 0; i < N; ++i) a2[i] *= kLog2e;
  }

  for (int k = 0; k < n_tiles; ++k) {
    const int s = k % kStages;
    const int yb = k & 1;
    if (lane == 0) repro::bulk_wait_read<1>();  // tile k-2's store of y[yb]
    __syncwarp();
    mbar_wait(&sm.full[s], (k / kStages) & 1);
    const int n = min(kSteps, Q - k * kSteps);
#pragma unroll 2
    for (int t = 0; t < n; ++t) {
      const float dtv = sm.dt[s][t][c];
      const float dx = __fmul_rn(dtv, sm.x[s][t][c]);
      float bv[N], cv[N];
      load_vec(bv, sm.b[s][t]);
      load_vec(cv, sm.c[s][t]);
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float dA = ex2(__fmul_rn(dtv, a2[i]));
        h[i] = __fmaf_rn(dA, h[i], __fmul_rn(dx, bv[i]));
        acc = i == 0 ? __fmul_rn(h[i], cv[i]) : __fmaf_rn(h[i], cv[i], acc);
      }
      sm.y[yb][warp][t][lane] = acc;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);
    repro::fence_async_smem();
    __syncwarp();
    if (lane == 0 && dw < Di) {
      repro::tma_store_3d(&t_y, sm.y[yb][warp], dw, k * kSteps, b);
      repro::bulk_commit();
    }
  }
  if (lane == 0) repro::bulk_wait<0>();
  if (live) store_vec(h_out + state, h);
}

// A 3-D map over a contiguous fp32 (d2, d1, d0) tensor, innermost first,
// with boxes of (box0, kSteps, 1); elements past an edge load as zeros
// and are not stored.
bool encode_map(CUtensorMap* map, const void* base, int d0, int d1, int d2,
                int box0) {
  auto fn = repro::tensor_map_encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {cuuint64_t(d0), cuuint64_t(d1),
                              cuuint64_t(d2)};
  const cuuint64_t strides[2] = {cuuint64_t(d0) * 4,
                                 cuuint64_t(d0) * d1 * 4};
  const cuuint32_t box[3] = {cuuint32_t(box0), cuuint32_t(kSteps), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int N>
int launch(const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* x, const void* h0, void* y, void* h_out, int B, int Q,
           int Di, cudaStream_t stream) {
  CUtensorMap t_dt, t_x, t_b, t_c, t_y;
  if (!encode_map(&t_dt, dt, Di, Q, B, kChannels) ||
      !encode_map(&t_x, x, Di, Q, B, kChannels) ||
      !encode_map(&t_b, Bm, N, Q, B, N) || !encode_map(&t_c, Cm, N, Q, B, N) ||
      !encode_map(&t_y, y, Di, Q, B, 32))
    return cudaErrorInvalidValue;
  auto kernel = selective_scan_kernel<N>;
  constexpr int kSmem = sizeof(Smem<N>);
  static bool ready = false;
  if (!ready) {
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem) != cudaSuccess)
      return cudaErrorInvalidConfiguration;
    ready = true;
  }
  const dim3 grid((Di + kChannels - 1) / kChannels, B);
  kernel<<<grid, kBlock, kSmem, stream>>>(
      t_dt, t_x, t_b, t_c, t_y, static_cast<const float*>(A),
      static_cast<const float*>(h0), static_cast<float*>(h_out), Q, Di);
  return cudaSuccess;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" int selective_scan_launch(const void* dt, const void* A,
                                     const void* Bm, const void* Cm,
                                     const void* x, const void* h0, void* y,
                                     void* h_out, int B, int Q, int Di, int N,
                                     void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || B > 65535 || Q <= 0 || Di <= 0 || Di % 4 ||
      !aligned16(dt) || !aligned16(A) || !aligned16(Bm) || !aligned16(Cm) ||
      !aligned16(x) || !aligned16(h0) || !aligned16(y) || !aligned16(h_out))
    return cudaErrorInvalidValue;
  int err;
  if (N == 8) {
    err = launch<8>(dt, A, Bm, Cm, x, h0, y, h_out, B, Q, Di, s);
  } else if (N == 16) {
    err = launch<16>(dt, A, Bm, Cm, x, h0, y, h_out, B, Q, Di, s);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
