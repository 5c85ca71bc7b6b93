// Fused LSTM cell: one step of the paper's dynamic_rnn (gate order i, f,
// g, o; forget bias +1),
//   z  = [x, h] @ w + b                       (B, 4H), fp32 accumulation
//   c' = sigmoid(f + 1) * c + sigmoid(i) * tanh(g)
//   h' = sigmoid(o) * tanh(c')
// Replaces the TPU kernel repro/kernels/lstm_cell/kernel.py (_lstm_kernel,
// launched by lstm_cell's pallas_call).
//
// What bounds it on the H100: operations. At B=512, D=H=512 the product is
// 2*B*(D+H)*4H = 2.15 GFLOP, 0.032 ms at the 67 TFLOP/s of fp32 FMAs,
// against 13.4 MB of operands and results, 0.004 ms at 3.35 TB/s. Every
// multiply-add runs on the fp32 pipes (no tensor cores: the plain
// version's fp32 matmul with TF32 off is the reference, to 1e-5).
//
// Both routes run the GEMM in the kernel's own body: a CTA owns a tile of
// rows x hidden units and accumulates all four gate columns of its units,
// so the gates are applied on chip and z never goes to device memory. x
// and h arrive as two pointers and the K loop crosses from one to the
// other at D (no concatenation); gate k of unit j is read at column
// k*H + j of the unreordered w (no column shuffle). Any B, D and H work:
// rows, units and K are masked at their tails. Precise expf and tanhf, as
// the plain version's torch.sigmoid and torch.tanh; c' and h' are written
// in the operands' type.
//
// fp32 route (the dynamic_rnn path). What the first port's body lost to
// torch.lstm_cell on, and what this one does about it:
// - Shared-memory loads bound it (32 FMAs a thread per 5 loads): each of
//   256 threads now owns an 8 x 8 block of z (8 rows x 8 of the CTA's
//   128 gate columns), and per 4 k reads 8 row vectors of [x, h] (16
//   bytes along k each) and 8 w vectors (16 bytes along the columns),
//   256 FMAs per 16 loads; a warp's row vectors fall in distinct banks
//   (rows padded to 80 bytes) and its w vectors are 256 contiguous bytes.
//   The gates need all four columns of a unit in one thread: the
//   epilogue regroups them through shared memory, which the cluster
//   reduction below passes through anyway.
// - Tiles went through registers with a transposing store: now 16-byte
//   cp.async from device memory straight into shared memory, 4 stages in
//   flight (a [x, h] tile is kept row-major, as in memory, which the
//   k-wise row vectors read). Shapes whose rows are not 16-byte aligned
//   (D or H not a multiple of 4) take 4-byte copies of the same layout.
// - 128 CTAs of 64 x 32 did not fill the SMs with work: the CTA tile is
//   now 128 rows x 32 units (one CTA an SM, up to 255 registers a
//   thread), and K = D + H is split across a thread-block cluster of
//   `split` CTAs (launch plan: kernels.lstm_cell.kernel.launch_plan; 2 at
//   B=512, D=H=512, 128 CTAs in one wave). Each CTA leaves its partial z
//   in its shared memory; after a cluster barrier, CTA r sums its
//   1/split of the tile's rows over the cluster's shared memory
//   (distributed shared memory) and applies the gates to them.
//
// bf16 route: the first port's body (64 rows x 32 units a CTA, operands
// converted to fp32 on their way into shared memory through registers,
// 4 rows x 2 units x 4 gates a thread); no configuration runs it on its
// main path.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;              // rows (batch) per CTA
constexpr int kUnits = 32;             // hidden units per CTA
constexpr int kK = 16;                 // K per shared-memory tile
constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;      // kRows / (kThreads / 16)
constexpr int kUnitsPerThread = 2;     // kUnits / 16
constexpr int kPad = 4;                // keeps xs rows 16-byte aligned
constexpr int kXLoads = kRows * kK / kThreads;        // per thread, per tile
constexpr int kWLoads = kK * 4 * kUnits / kThreads;

__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// The bf16 route's body.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    lstm_cell_kernel(const T* __restrict__ w, const T* __restrict__ b,
                     const T* __restrict__ x, const T* __restrict__ c,
                     const T* __restrict__ h, T* __restrict__ c_out,
                     T* __restrict__ h_out, int B, int D, int H) {
  // Two buffers: the tile being multiplied and the next one being stored.
  __shared__ __align__(16) float xs[2][kK][kRows + kPad];
  __shared__ __align__(16) float ws[2][kK][4 * kUnits];

  const int row0 = blockIdx.y * kRows;
  const int unit0 = blockIdx.x * kUnits;
  const int tid = threadIdx.x;
  const int tx = tid % 16;    // unit pair: units unit0 + 2*tx + {0, 1}
  const int ty = tid / 16;    // row quad: rows row0 + 4*ty + {0..3}
  const int K = D + H;
  const size_t H4 = 4 * static_cast<size_t>(H);

  // The next tile's values, loaded from device memory into registers
  // while the current tile is multiplied (software pipelining).
  float xr[kXLoads], wr[kWLoads];
  auto fetch = [&](int k0) {
    // [x, h] tile, kRows x kK: consecutive threads walk k within a row,
    // so each row's 16 values are one coalesced segment.
#pragma unroll
    for (int l = 0; l < kXLoads; ++l) {
      const int idx = tid + l * kThreads;
      const int row = row0 + idx / kK;
      const int k = k0 + idx % kK;
      float v = 0.f;
      if (row < B && k < K) {
        v = k < D ? load(x + static_cast<size_t>(row) * D + k)
                  : load(h + static_cast<size_t>(row) * H + (k - D));
      }
      xr[l] = v;
    }
    // w tile, kK x (4 gates x kUnits): gate g of unit u is column g*H + u.
#pragma unroll
    for (int l = 0; l < kWLoads; ++l) {
      const int idx = tid + l * kThreads;
      const int col = idx % (4 * kUnits);
      const int unit = unit0 + col % kUnits;
      const int k = k0 + idx / (4 * kUnits);
      wr[l] = (unit < H && k < K)
                  ? load(w + static_cast<size_t>(k) * H4 +
                         static_cast<size_t>(col / kUnits) * H + unit)
                  : 0.f;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int l = 0; l < kXLoads; ++l) {
      const int idx = tid + l * kThreads;
      xs[buf][idx % kK][idx / kK] = xr[l];     // stored transposed
    }
#pragma unroll
    for (int l = 0; l < kWLoads; ++l) {
      const int idx = tid + l * kThreads;
      ws[buf][idx / (4 * kUnits)][idx % (4 * kUnits)] = wr[l];
    }
  };

  float acc[4][kRowsPerThread][kUnitsPerThread];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kUnitsPerThread; ++j) acc[g][i][j] = 0.f;

  const int n_tiles = (K + kK - 1) / kK;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int t = 0; t < n_tiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < n_tiles) fetch((t + 1) * kK);
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[cur][kk][4 * ty]);
      const float av[kRowsPerThread] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float2 bw = *reinterpret_cast<const float2*>(
            &ws[cur][kk][g * kUnits + 2 * tx]);
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          acc[g][i][0] = fmaf(av[i], bw.x, acc[g][i][0]);
          acc[g][i][1] = fmaf(av[i], bw.y, acc[g][i][1]);
        }
      }
    }
    // The other buffer was last read before the previous barrier.
    if (t + 1 < n_tiles) stash(cur ^ 1);
    __syncthreads();
  }

  // Gate epilogue in registers; c' and h' written once.
#pragma unroll
  for (int j = 0; j < kUnitsPerThread; ++j) {
    const int unit = unit0 + 2 * tx + j;
    if (unit >= H) continue;
    const float bi = load(b + unit);
    const float bf = load(b + H + unit);
    const float bg = load(b + 2 * H + unit);
    const float bo = load(b + 3 * H + unit);
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = row0 + 4 * ty + i;
      if (row >= B) continue;
      const size_t o = static_cast<size_t>(row) * H + unit;
      const float cn = sigmoid(acc[1][i][j] + bf + 1.f) * load(c + o) +
                       sigmoid(acc[0][i][j] + bi) * tanhf(acc[2][i][j] + bg);
      store(c_out + o, cn);
      store(h_out + o, sigmoid(acc[3][i][j] + bo) * tanhf(cn));
    }
  }
}


// ---------------------------------------------------------- fp32 route

namespace cg = cooperative_groups;

constexpr int kGRows = 128;            // rows per CTA
constexpr int kGUnits = 32;            // units per CTA (128 z columns)
constexpr int kGK = 16;                // K per stage
constexpr int kGStages = 4;
constexpr int kAStride = kGK + 4;      // floats: 80-byte rows
constexpr int kAFloats = kGRows * kAStride;
constexpr int kWFloats = kGK * 4 * kGUnits;
constexpr int kStageFloats = kAFloats + kWFloats;
constexpr int kRedFloats = 4 * kGRows * kGUnits;   // partial z, [g][row][u]
constexpr int kGSmemBytes =
    4 * (kGStages * kStageFloats > kRedFloats ? kGStages * kStageFloats
                                              : kRedFloats);

static_assert(kGSmemBytes <= 232448,
              "the stages must fit one block's shared memory (H100)");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// cp.async of `Bytes` (16 or 4); zero-filled when !valid (src unread)
template <int Bytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  if constexpr (Bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Vec: every row of x, h and w starts 16-byte aligned (D % 4 == 0,
// H % 4 == 0, aligned bases), so a copy takes 4 floats.
template <bool Vec>
__global__ void __launch_bounds__(kThreads, 1)
lstm_cell_fp32_kernel(const float* __restrict__ w, const float* __restrict__ b,
                      const float* __restrict__ x, const float* __restrict__ c,
                      const float* __restrict__ h, float* __restrict__ c_out,
                      float* __restrict__ h_out, int B, int D, int H,
                      int k_per_split) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int unit0 = blockIdx.x * kGUnits;
  const int row0 = blockIdx.y * kGRows;
  const int K = D + H;
  const int k_lo = rank * k_per_split;
  const int k_hi = min(K, k_lo + k_per_split);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kGK - 1) / kGK : 0;
  const size_t H4 = 4 * static_cast<size_t>(H);
  const int tid = threadIdx.x;

  // One stage: the [x, h] tile row-major (kGRows x kGK, rows padded to
  // kAStride) and the w tile as 4 gate strips of kGUnits units per k.
  auto load_tile = [&](int t, int stage) {
    float* as = smem + stage * kStageFloats;
    float* ws = as + kAFloats;
    const int k0 = k_lo + t * kGK;
    constexpr int kW = Vec ? 4 : 1;               // floats per copy
#pragma unroll
    for (int l = 0; l < kGRows * kGK / kW / kThreads; ++l) {
      const int e = tid + l * kThreads;
      const int row = e / (kGK / kW), kk = kW * (e % (kGK / kW));
      const int k = k0 + kk, grow = row0 + row;
      const bool ok = grow < B && k < k_hi;
      const float* src = w;             // any mapped address: unread
      if (ok) src = k < D ? x + static_cast<size_t>(grow) * D + k
                          : h + static_cast<size_t>(grow) * H + (k - D);
      cp_async<4 * kW>(as + row * kAStride + kk, src, ok);
    }
#pragma unroll
    for (int l = 0; l < kWFloats / kW / kThreads; ++l) {
      const int e = tid + l * kThreads;
      const int kk = e / (4 * kGUnits / kW);
      const int col = kW * (e % (4 * kGUnits / kW));
      const int gate = col / kGUnits, u = unit0 + col % kGUnits;
      const int k = k0 + kk;
      const bool ok = k < k_hi && u < H;
      const float* src =
          ok ? w + static_cast<size_t>(k) * H4 +
                   static_cast<size_t>(gate) * H + u
             : w;
      cp_async<4 * kW>(ws + kk * 4 * kGUnits + col, src, ok);
    }
  };

  // this thread's 8 x 8 block of the CTA's 128 x 128 z tile (z columns
  // gate-major, g * kGUnits + unit): rows ty + 16i, columns 4tx + j and
  // 64 + 4tx + j (i < 8, j < 4), so a warp's two rows sit 80 bytes apart
  // and its w reads are 256 contiguous bytes
  const int tx = tid % 16, ty = tid / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int t = 0; t < kGStages - 1; ++t) {
    if (t < n_tiles) load_tile(t, t);
    cp_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_wait<kGStages - 2>();          // tile t has landed
    __syncthreads();                  // ... for every thread; and tile
                                      // t - 1's stage is free again
    const int next = t + kGStages - 1;
    if (next < n_tiles) load_tile(next, next % kGStages);
    cp_commit();
    const float* as = smem + (t % kGStages) * kStageFloats;
    const float* ws = as + kAFloats;
#pragma unroll
    for (int kq = 0; kq < kGK / 4; ++kq) {
      float4 a[8];                    // rows ty + 16i at k 4kq .. 4kq + 3
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            as + (ty + 16 * i) * kAStride + 4 * kq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* wk = ws + (4 * kq + kk) * 4 * kGUnits + 4 * tx;
        const float4 w0 = *reinterpret_cast<const float4*>(wk);
        const float4 w1 = *reinterpret_cast<const float4*>(wk + 64);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y
                         : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, wv[j], acc[i][j]);
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();                    // every stage read: reuse as red

  // partial z of this CTA's K range into shared memory, [g][row][unit]
  float* red = smem;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = ty + 16 * i;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = 64 * half + 4 * tx;
      *reinterpret_cast<float4*>(
          red + ((col / kGUnits) * kGRows + row) * kGUnits + col % kGUnits) =
          make_float4(acc[i][4 * half], acc[i][4 * half + 1],
                      acc[i][4 * half + 2], acc[i][4 * half + 3]);
    }
  }
  cluster.sync();                     // every partial of the cluster written

  // CTA `rank` finishes rows [rank, rank + 1) * kGRows / split of the
  // tile: z summed over the cluster's partials, then the gates
  const int rows = kGRows / split;
  for (int it = tid; it < rows * (kGUnits / 4); it += kThreads) {
    const int row = rank * rows + it / (kGUnits / 4);
    const int q = it % (kGUnits / 4);
    float z[4][4];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) z[g][j] = 0.f;
    for (int r = 0; r < split; ++r) {
      const float* part = cluster.map_shared_rank(red, r);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            part + (g * kGRows + row) * kGUnits + 4 * q);
        z[g][0] += v.x; z[g][1] += v.y; z[g][2] += v.z; z[g][3] += v.w;
      }
    }
    const int grow = row0 + row;
    if (grow >= B) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int unit = unit0 + 4 * q + j;
      if (unit >= H) continue;
      const size_t o = static_cast<size_t>(grow) * H + unit;
      const float cn =
          sigmoid(z[1][j] + b[H + unit] + 1.f) * c[o] +
          sigmoid(z[0][j] + b[unit]) * tanhf(z[2][j] + b[2 * H + unit]);
      c_out[o] = cn;
      h_out[o] = sigmoid(z[3][j] + b[3 * H + unit]) * tanhf(cn);
    }
  }
  cluster.sync();                     // partials stay until all are read
}

template <bool Vec>
int launch_fp32(const void* w, const void* b, const void* x, const void* c,
                const void* h, void* c_out, void* h_out, int B, int D, int H,
                int split, cudaStream_t stream) {
  auto kernel = lstm_cell_fp32_kernel<Vec>;
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGSmemBytes);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  const int K = D + H;
  const int k_tiles = (K + kGK - 1) / kGK;
  const int k_per_split = (k_tiles + split - 1) / split * kGK;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((H + kGUnits - 1) / kGUnits, (B + kGRows - 1) / kGRows,
                     split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kGSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<const float*>(x), static_cast<const float*>(c),
      static_cast<const float*>(h), static_cast<float*>(c_out),
      static_cast<float*>(h_out), B, D, H, k_per_split);
}

template <typename T>
void launch(const void* w, const void* b, const void* x, const void* c,
            const void* h, void* c_out, void* h_out, int B, int D, int H,
            cudaStream_t stream) {
  const dim3 grid((H + kUnits - 1) / kUnits, (B + kRows - 1) / kRows);
  lstm_cell_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<const T*>(x), static_cast<const T*>(c),
      static_cast<const T*>(h), static_cast<T*>(c_out), static_cast<T*>(h_out),
      B, D, H);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every operand and both results).
// split: the fp32 route's cluster size along K, from the wrapper's
// launch plan (1, 2, 4 or 8; the bf16 route takes 1).
extern "C" int lstm_cell_launch(const void* w, const void* b, const void* x,
                                const void* c, const void* h, void* c_out,
                                void* h_out, int B, int D, int H, int dtype,
                                int split, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || D < 0 || B > 65535 * kGRows)
    return cudaErrorInvalidValue;
  if (dtype == 0) {
    if (split != 1 && split != 2 && split != 4 && split != 8)
      return cudaErrorInvalidValue;
    const bool vec =
        D % 4 == 0 && H % 4 == 0 &&
        ((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(x) |
          reinterpret_cast<uintptr_t>(h)) & 15) == 0;
    const int err =
        vec ? launch_fp32<true>(w, b, x, c, h, c_out, h_out, B, D, H, split,
                                s)
            : launch_fp32<false>(w, b, x, c, h, c_out, h_out, B, D, H, split,
                                 s);
    if (err != cudaSuccess) return err;
  } else if (dtype == 1) {
    if (split != 1) return cudaErrorInvalidValue;
    launch<__nv_bfloat16>(w, b, x, c, h, c_out, h_out, B, D, H, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
