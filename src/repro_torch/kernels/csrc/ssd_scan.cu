// Mamba-2 chunked SSD scan (state-space duality, arXiv:2405.21060).
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan.py::_ssd_kernel,
// whose sequential grid walks the chunks of one (batch, head) and carries
// the (P x N) state in VMEM scratch.  CUDA blocks run in no order, so one
// CTA owns a (batch, head) and walks its chunks in a loop, the state kept in
// shared memory the whole time.  Per chunk of L steps, with cum the
// inclusive cumsum of la = -a * dt over the chunk:
//
//   G[t][u] = (C_t . B_u) * exp(cum_t - cum_u) * dt_u    for u <= t, else 0
//   y_t     = sum_u G[t][u] x_u + exp(cum_t) * (C_t . state)
//   state   = exp(cum_{L-1}) * state + sum_u x_u exp(cum_{L-1} - cum_u) dt_u B_u
//
// exp is taken on the lower triangle only: above it cum_t - cum_u > 0 and
// would overflow (the Pallas kernel masks it the same way).  A ragged last
// chunk is read as zeros past S: its steps have dt = 0, so decay 1 and no
// input, and the state after the chunk is the state at step S.  The initial
// state is loaded into the carry directly (the Pallas wrapper folds it in
// outside the kernel; the function is the same).
//
// Shared memory per CTA: x, B and C of the chunk, G (L x L), the state and
// three length-L vectors -- 180 KB at L = 128, P = N = 64, so the kernel
// opts in to more than 48 KB (the wrapper picks a shorter L when P and N
// would not fit; the scan's result does not depend on L).  B, C and the
// state rows are padded to N + 1 floats so the column reads of different
// rows fall in different banks.
//
// Bound on the card: f32 flops, about L * (N + P) + 2 * P * N
// multiply-adds per step and head; memory traffic is one read of x, dt, B,
// C and one write of y.  This first version runs on CUDA cores from shared
// memory, not on tensor cores, and uses H * B CTAs (80 at the serving
// path's prefill), fewer than the card's 132 SMs.
#include <cuda_bf16.h>

#include <math.h>

#include "dtype.cuh"
#include "kernels.h"

namespace repro {
namespace {

constexpr int kThreads = 256;

// Dynamic shared memory of one CTA (kernels/ssd_scan.py computes the same
// to pick L).
size_t ssd_smem_bytes(int L, int P, int N) {
  return sizeof(float) * (static_cast<size_t>(L) * P +
                          2 * static_cast<size_t>(L) * (N + 1) +
                          static_cast<size_t>(L) * L +
                          static_cast<size_t>(P) * (N + 1) + 3 * L);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_kernel(SsdArgs a) {
  extern __shared__ float smem[];
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ dt = static_cast<const T*>(a.dt);
  const T* __restrict__ bm = static_cast<const T*>(a.b);
  const T* __restrict__ cm = static_cast<const T*>(a.c);
  const int L = a.L, P = a.P, N = a.N, S = a.S, H = a.H;
  const int NP = N + 1;
  float* xs = smem;             // L * P
  float* bs = xs + L * P;       // L * NP
  float* cs = bs + L * NP;      // L * NP
  float* g = cs + L * NP;       // L * L
  float* st = g + L * L;        // P * NP, the carried state
  float* cum = st + P * NP;     // L
  float* dts = cum + L;         // L
  float* wt = dts + L;          // L, exp(cum_{L-1} - cum_u) * dt_u

  const int h = blockIdx.x;
  const int bb = blockIdx.y;
  const int tid = threadIdx.x;
  const float ah = a.a[h];
  const long long state_base = (static_cast<long long>(bb) * H + h) * P * N;

  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N;
    const int n = i - p * N;
    st[p * NP + n] = a.init ? a.init[state_base + i] : 0.f;
  }

  const int n_chunks = (S + L - 1) / L;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * L;
    __syncthreads();  // the previous chunk's readers are done
    for (int u = tid; u < L; u += kThreads) {
      const int t = t0 + u;
      dts[u] = t < S ? to_f32(dt[(static_cast<long long>(bb) * S + t) * H + h])
                     : 0.f;
    }
    for (int i = tid; i < L * P; i += kThreads) {
      const int u = i / P;
      const int p = i - u * P;
      const int t = t0 + u;
      xs[i] = t < S ? to_f32(x[((static_cast<long long>(bb) * S + t) * H + h) *
                                   P + p])
                    : 0.f;
    }
    for (int i = tid; i < L * N; i += kThreads) {
      const int u = i / N;
      const int n = i - u * N;
      const int t = t0 + u;
      const long long off = (static_cast<long long>(bb) * S + t) * N + n;
      bs[u * NP + n] = t < S ? to_f32(bm[off]) : 0.f;
      cs[u * NP + n] = t < S ? to_f32(cm[off]) : 0.f;
    }
    __syncthreads();
    if (tid == 0) {  // the inclusive cumsum, in order (L <= 128 adds)
      float run = 0.f;
      for (int u = 0; u < L; ++u) {
        run += -ah * dts[u];
        cum[u] = run;
      }
    }
    __syncthreads();
    const float c_last = cum[L - 1];
    for (int u = tid; u < L; u += kThreads) wt[u] = expf(c_last - cum[u]) * dts[u];
    for (int i = tid; i < L * L; i += kThreads) {
      const int t = i / L;
      const int u = i - t * L;
      float val = 0.f;
      if (u <= t) {
        float dot = 0.f;
        for (int n = 0; n < N; ++n) dot += cs[t * NP + n] * bs[u * NP + n];
        val = dot * expf(cum[t] - cum[u]) * dts[u];
      }
      g[i] = val;
    }
    __syncthreads();
    for (int i = tid; i < L * P; i += kThreads) {
      const int t = i / P;
      const int p = i - t * P;
      if (t0 + t >= S) continue;
      float intra = 0.f;
      for (int u = 0; u <= t; ++u) intra += g[t * L + u] * xs[u * P + p];
      float inter = 0.f;
      for (int n = 0; n < N; ++n) inter += cs[t * NP + n] * st[p * NP + n];
      a.y[((static_cast<long long>(bb) * S + t0 + t) * H + h) * P + p] =
          intra + expf(cum[t]) * inter;
    }
    __syncthreads();  // every read of the old state is done
    const float chunk_decay = expf(c_last);
    for (int i = tid; i < P * N; i += kThreads) {
      const int p = i / N;
      const int n = i - p * N;
      float upd = 0.f;
      for (int u = 0; u < L; ++u) upd += xs[u * P + p] * wt[u] * bs[u * NP + n];
      st[p * NP + n] = st[p * NP + n] * chunk_decay + upd;
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N;
    const int n = i - p * N;
    a.state[state_base + i] = st[p * NP + n];
  }
}

template <typename T>
cudaError_t launch(const SsdArgs& a, cudaStream_t stream) {
  const size_t smem = ssd_smem_bytes(a.L, a.P, a.N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssd_kernel<T><<<dim3(a.H, a.B), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_ssd_scan(const SsdArgs& a, int dtype,
                            cudaStream_t stream) {
  if (a.L <= 0 || a.P <= 0 || a.N <= 0) return cudaErrorInvalidValue;
  if (a.B <= 0 || a.H <= 0) return cudaSuccess;
  if (dtype == kBF16) return launch<__nv_bfloat16>(a, stream);
  if (dtype != kF32) return cudaErrorInvalidValue;
  return launch<float>(a, stream);
}

}  // namespace repro
