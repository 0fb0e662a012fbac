// Online-softmax ("flash") attention with GQA, causal, sliding-window and
// valid-length masks, for prefill (Sq = Sk) and decode (Sq = 1 against a
// cache).
//
// Replaces the Pallas kernel
// src/repro/kernels/flash_attention.py::_attn_kernel.  The TPU kernel walks
// KV blocks as the innermost, sequential grid axis and keeps the running
// (acc, m, l) in VMEM scratch between grid steps.  CUDA blocks run in no
// order, so here one CTA owns a (batch, head, 16-query block) and loops over
// the KV tiles itself, with (m, l) and its slice of acc in registers:
//
//   * 128 threads; 8 threads per query row.  A thread computes 4 of the 32
//     scores of a KV tile (dot products over the head dim from shared
//     memory), the row's max and sum come from warp shuffles within its 8
//     lanes, and the thread keeps acc for head-dim columns lane, lane + 8, ...
//     (any head dim up to 128, so Dh = 80 needs no padding to a power of 2).
//   * Q is staged once, pre-multiplied by the softmax scale in f32 (as both
//     JAX paths do); each KV tile is converted to f32 on its way into shared
//     memory (K rows padded to D + 1 floats so the column reads of different
//     rows fall in different banks).
//   * The loop visits only the tiles that can hold a visible key: from the
//     left edge of the window to min(kv_valid, last query + 1).  A decode
//     step against a cache padded to max_len therefore does work in
//     proportion to the cache length, not to max_len.
//   * A row with no visible key ends with l = 0 and is written as 0, as the
//     Pallas kernel and layers.chunked_attention give.
//
// Bound on the card: at the prefill shapes the f32 flops (4 * Sq * Sk * D
// per head, halved by the causal mask) against the 67 TFLOP/s f32 rate;
// in decode the bytes of the K/V cache up to the cache length.  This first
// version uses CUDA cores and shared memory, not wgmma, and is far from
// either bound; a tensor-core version is later work.
#include <cuda_bf16.h>

#include <math.h>

#include "dtype.cuh"
#include "kernels.h"

namespace repro {
namespace {

constexpr int kBQ = 16;                 // query rows per CTA
constexpr int kBK = 32;                 // keys per KV tile
constexpr int kTPR = 8;                 // threads per query row
constexpr int kThreads = kBQ * kTPR;    // 128
constexpr int kMaxD = 128;
constexpr int kDPT = kMaxD / kTPR;      // acc columns per thread
constexpr int kSPT = kBK / kTPR;        // scores per thread per tile

__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = kTPR / 2; o > 0; o >>= 1) {
    const float n = __shfl_xor_sync(0xffffffffu, v, o);
    v = v > n ? v : n;
  }
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = kTPR / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attn_kernel(AttnArgs a) {
  extern __shared__ float smem[];
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ k = static_cast<const T*>(a.k);
  const T* __restrict__ v = static_cast<const T*>(a.v);
  T* __restrict__ o = static_cast<T*>(a.o);
  const int D = a.D;
  const int DK = D + 1;
  float* qs = smem;                 // kBQ * D, scaled queries
  float* ks = qs + kBQ * D;         // kBK * DK
  float* vs = ks + kBK * DK;        // kBK * D
  float* ps = vs + kBK * D;         // kBQ * (kBK + 1), probabilities

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int tid = threadIdx.x;
  const int r = tid / kTPR;
  const int lane = tid % kTPR;
  const int rows = min(kBQ, a.Sq - q0);
  const int q_lo = a.q_offset + q0;
  const int q_hi = q_lo + rows - 1;
  const bool row_ok = r < rows;
  const int my_q = q_lo + r;
  const int kv_lim = min(a.kv_valid, a.Sk);

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int rr = i / D;
    const int dd = i - rr * D;
    float val = 0.f;
    if (rr < rows) {
      const long long off =
          ((static_cast<long long>(b) * a.Sq + q0 + rr) * a.H + h) * D + dd;
      val = to_f32(q[off]) * a.scale;
    }
    qs[i] = val;
  }

  int k_end = kv_lim;
  if (a.causal) k_end = min(k_end, q_hi + 1);
  int k_begin = 0;
  if (a.window > 0) k_begin = max(0, q_lo - a.window + 1);
  k_begin = (k_begin / kBK) * kBK;

  float m = -INFINITY;
  float l = 0.f;
  float acc[kDPT];
#pragma unroll
  for (int i = 0; i < kDPT; ++i) acc[i] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // Q staged; the previous tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int j = i / D;
      const int dd = i - j * D;
      const int kj = k0 + j;
      float kval = 0.f, vval = 0.f;
      if (kj < a.Sk) {
        const long long off =
            ((static_cast<long long>(b) * a.Sk + kj) * a.Hkv + hk) * D + dd;
        kval = to_f32(k[off]);
        vval = to_f32(v[off]);
      }
      ks[j * DK + dd] = kval;
      vs[j * D + dd] = vval;
    }
    __syncthreads();

    float s[kSPT];
#pragma unroll
    for (int jj = 0; jj < kSPT; ++jj) s[jj] = 0.f;
    for (int dd = 0; dd < D; ++dd) {
      const float qv = qs[r * D + dd];
#pragma unroll
      for (int jj = 0; jj < kSPT; ++jj) {
        s[jj] += qv * ks[(lane + kTPR * jj) * DK + dd];
      }
    }
    float mx = -INFINITY;
    bool ok[kSPT];
#pragma unroll
    for (int jj = 0; jj < kSPT; ++jj) {
      const int kj = k0 + lane + kTPR * jj;
      bool live = row_ok && kj < kv_lim;
      if (a.causal) live = live && kj <= my_q;
      if (a.window > 0) live = live && kj > my_q - a.window;
      ok[jj] = live;
      if (!live) s[jj] = -INFINITY;
      mx = mx > s[jj] ? mx : s[jj];
    }
    mx = row_max(mx);
    const float m_new = m > mx ? m : mx;
    const float m_safe = m_new == -INFINITY ? 0.f : m_new;
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < kSPT; ++jj) {
      const float p = ok[jj] ? expf(s[jj] - m_safe) : 0.f;
      ps[r * (kBK + 1) + lane + kTPR * jj] = p;
      psum += p;
    }
    psum = row_sum(psum);
    const float corr = m == -INFINITY ? 0.f : expf(m - m_safe);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();  // a row's 8 threads share one warp
#pragma unroll
    for (int i = 0; i < kDPT; ++i) {
      const int d = lane + kTPR * i;
      if (d < D) {
        float t = 0.f;
        for (int j = 0; j < kBK; ++j) t += ps[r * (kBK + 1) + j] * vs[j * D + d];
        acc[i] = acc[i] * corr + t;
      }
    }
  }

  if (!row_ok) return;
  const long long base =
      ((static_cast<long long>(b) * a.Sq + q0 + r) * a.H + h) * D;
#pragma unroll
  for (int i = 0; i < kDPT; ++i) {
    const int d = lane + kTPR * i;
    if (d < D) o[base + d] = from_f32<T>(l > 0.f ? acc[i] / l : 0.f);
  }
}

template <typename T>
cudaError_t launch(const AttnArgs& a, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kBQ * a.D + kBK * (a.D + 1) + kBK * a.D +
                       kBQ * (kBK + 1));
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
  attn_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_flash_attention(const AttnArgs& a, int dtype,
                                   cudaStream_t stream) {
  if (a.D <= 0 || a.D > kMaxD || a.Hkv <= 0 || a.H % a.Hkv != 0) {
    return cudaErrorInvalidValue;
  }
  if (a.B <= 0 || a.Sq <= 0 || a.H <= 0) return cudaSuccess;
  if (dtype == kBF16) return launch<__nv_bfloat16>(a, stream);
  if (dtype != kF32) return cudaErrorInvalidValue;
  return launch<float>(a, stream);
}

}  // namespace repro
