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
// against 13.4 MB of operands and results, 0.004 ms at 3.35 TB/s. This
// first kernel does its multiply-adds on the fp32 pipes (no tensor cores,
// as the plain version's fp32 matmul with TF32 off); wgmma and TMA are
// later work.
//
// Design. The GEMM runs in the kernel's own body: one CTA owns a tile of
// 64 rows x 32 hidden units and accumulates all four gate columns of its
// units (4 x 32 columns of z), so the gate epilogue is applied in
// registers and c' and h' are written once; z never goes to device
// memory. The two per-call copies of the TPU wrapper are gone: x and h
// arrive as two pointers and the K loop crosses from one to the other at
// D (no concatenation), and gate k of unit j is read at column k*H + j of
// the unreordered w (no column shuffle). K is walked in tiles of 16 staged
// in shared memory: the [x, h] tile transposed (so a thread's 4 rows are
// one 16-byte load) and the w tile as 4 gate strips of 32 units. The next
// tile is loaded into registers while the current one is multiplied, and
// the two shared-memory buffers alternate, one barrier per tile. Each of
// the 256 threads owns 4 rows x 2 units x 4 gates = 32 fp32 accumulators;
// 8 warps per SM at B=512, H=512 (128 CTAs).
// Any B, D and H work: rows, units and K are masked at their tails (the
// TPU's B % blk_b == 0 does not carry over). Operands are fp32 or bf16
// (converted to fp32 on their way into shared memory); c' and h' are
// written in the operands' type. Precise expf and tanhf, as the plain
// version's torch.sigmoid and torch.tanh.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

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
extern "C" int lstm_cell_launch(const void* w, const void* b, const void* x,
                                const void* c, const void* h, void* c_out,
                                void* h_out, int B, int D, int H, int dtype,
                                void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || D < 0) return cudaErrorInvalidValue;
  if (dtype == 0) {
    launch<float>(w, b, x, c, h, c_out, h_out, B, D, H, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(w, b, x, c, h, c_out, h_out, B, D, H, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
