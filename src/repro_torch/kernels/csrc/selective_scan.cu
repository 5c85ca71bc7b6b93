// Selective scan: the mamba1 recurrence over one chunk of Q steps,
//   h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t * B_t,   y_t = <h_t, C_t>,
// with the state h carried in (h0) and out (h_out). Replaces the TPU
// kernel repro/kernels/selective_scan/kernel.py (_ss_kernel, launched by
// selective_scan's pallas_call).
//
// What bounds it on the H100: bytes and the exponentials, nearly equally.
// Each (row, channel) reads Q values of dt and x and writes Q of y (fp32),
// and reads and writes its N-state once: at B=8, Q=128, Di=8192, N=16
// that is 110 MB, 0.033 ms at 3.35 TB/s. It also takes B*Q*Di*N = 1.3e8
// expf, whose ex2 runs in the SFU at 16 results per clock per SM.
//
// Design: one thread owns one (row b, channel d) pair and keeps A[d, :] and
// its N-vector h in registers for the whole chunk, so h never goes to
// device memory between steps (what the TPU kernel's VMEM scratch did).
// A CTA is 128 consecutive channels of one row: its loads of dt and x and
// its stores of y are coalesced across channels, and the next step's dt
// and x are loaded before this step's math. The row's B_ and C_ (shared by
// all channels) are staged in shared memory 64 steps at a time, so any Q
// fits. The TPU grid's sequential walk down the chunk becomes the loop
// over t inside each thread; channels are independent, so nothing crosses
// CTAs. Precise expf (not __expf), as the plain version's torch.exp.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // channels per CTA
constexpr int kTile = 64;      // steps of B_ and C_ staged at once

template <int N>
__global__ void __launch_bounds__(kThreads)
    selective_scan_kernel(const float* __restrict__ dt,
                          const float* __restrict__ A,
                          const float* __restrict__ Bm,
                          const float* __restrict__ Cm,
                          const float* __restrict__ x,
                          const float* __restrict__ h0,
                          float* __restrict__ y, float* __restrict__ h_out,
                          int Q, int Di) {
  __shared__ float sB[kTile][N];
  __shared__ float sC[kTile][N];
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool live = d < Di;

  float a[N], h[N];
  const size_t state = (static_cast<size_t>(b) * Di + d) * N;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = live ? A[static_cast<size_t>(d) * N + n] : 0.f;
    h[n] = live ? h0[state + n] : 0.f;
  }

  const float* Bb = Bm + static_cast<size_t>(b) * Q * N;
  const float* Cb = Cm + static_cast<size_t>(b) * Q * N;
  size_t off = static_cast<size_t>(b) * Q * Di + d;  // (b, t, d)
  float dt_next = 0.f, x_next = 0.f;
  if (live && Q > 0) {
    dt_next = dt[off];
    x_next = x[off];
  }
  for (int t = 0; t < Q; ++t, off += Di) {
    const int s = t % kTile;
    if (s == 0) {  // uniform across the CTA: every thread runs every t
      __syncthreads();
      const int n_vals = min(kTile, Q - t) * N;
      for (int i = threadIdx.x; i < n_vals; i += kThreads) {
        sB[i / N][i % N] = Bb[static_cast<size_t>(t) * N + i];
        sC[i / N][i % N] = Cb[static_cast<size_t>(t) * N + i];
      }
      __syncthreads();
    }
    const float dtv = dt_next;
    const float dx = dtv * x_next;
    if (live && t + 1 < Q) {
      dt_next = dt[off + Di];
      x_next = x[off + Di];
    }
    if (live) {
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = expf(dtv * a[n]) * h[n] + dx * sB[s][n];
        acc += h[n] * sC[s][n];
      }
      y[off] = acc;
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) h_out[state + n] = h[n];
  }
}

template <int N>
void launch(const void* dt, const void* A, const void* Bm, const void* Cm,
            const void* x, const void* h0, void* y, void* h_out, int B,
            int Q, int Di, cudaStream_t stream) {
  const dim3 grid((Di + kThreads - 1) / kThreads, B);
  selective_scan_kernel<N><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<const float*>(x), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(h_out), Q, Di);
}

}  // namespace

extern "C" int selective_scan_launch(const void* dt, const void* A,
                                     const void* Bm, const void* Cm,
                                     const void* x, const void* h0, void* y,
                                     void* h_out, int B, int Q, int Di, int N,
                                     void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (N == 8) {
    launch<8>(dt, A, Bm, Cm, x, h0, y, h_out, B, Q, Di, s);
  } else if (N == 16) {
    launch<16>(dt, A, Bm, Cm, x, h0, y, h_out, B, Q, Di, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
