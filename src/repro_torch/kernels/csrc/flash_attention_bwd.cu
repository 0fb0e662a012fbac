// The gradient of flash attention, for training: dQ, dK and dV of the
// prefill variant's function (flash_attention.cu), given its output O, each
// row's log-sum-exp (written by the forward on request) and dO.
//
// Replaces no TPU kernel: the Pallas kernel
// src/repro/kernels/flash_attention.py::_attn_kernel has no backward, and
// the JAX package trains through layers.chunked_attention, whose plain ops
// XLA differentiates.  The port's layers run attention through the CUDA
// kernel, whose output carries no autograd graph, so its gradient is a
// kernel of its own (kernels/flash_attention.py::_Attention).
//
// Bound on the card: the larger of the bytes (q, k, v, o, dO and lse read
// once, dq, dk and dv written once) at 3.35 TB/s and the least operations,
// 2 (3 D + 2 Dv) a visible (query, key) pair, at the route's rate (bf16
// 989 TFLOP/s, split TF32 495 / 3): bytes at internvl2's bf16 call,
// operations at the others (PERF.md, row 4b).  The kernels compute S =
// Q K^T again (2 D flops a pair), dP = dO V^T (2 Dv), dV += P^T dO (2 Dv),
// dK += dS^T Q (2 D) and, in the dQ kernel, S and dP once more and dQ +=
// dS K (2 D + 2 D + 2 Dv): 2 (4 D + 4 Dv) in all (the dQ kernel recomputes
// S and dP instead of sharing dS through atomics, whose order, and so
// whose bits, would change from run to run).
//
// Three kernels a call, each deterministic (no atomics: every output
// element is written once, by one thread, after a fixed order of sums):
//   * delta_kernel: D_i = sum_c dO_ic O_ic for each row, a warp a row.
//   * a dK / dV kernel: a CTA takes a tile of keys of one (batch, KV head)
//     and walks the query tiles of every query head of the KV head's group
//     (GQA needs no atomics), only those the mask lets see a key of it.
//   * a dQ kernel: a CTA takes 64 queries of one (batch, head) and walks
//     the key tiles they see, the last query blocks first (they see the
//     most keys).
// P is recomputed from the saved log-sum-exp in exp2 (scores times scale *
// log2 e, lse times log2 e; bf16: ex2.approx, whose ~2^-22 relative error
// sits far below the bf16 rounding of P that follows; f32: exp2f); a row
// that saw no key has lse = +inf and gives P = 0.  dS is scaled by the
// softmax scale once, when dQ and dK are written.
//
// bf16 runs on Hopper's warpgroup products: flash_attention_bwd_wgmma.cu
// has its kernels and their design.
// f32 runs on split TF32 mma.sync (mma.cuh; TF32 wgmma takes K-major
// operands only, and dV += P^T dO would need dO transposed): 4 warps own
// 64 keys (16 a warp) and walk 32-query tiles, and the dQ kernel 64
// queries over 32-key tiles, with attention.cuh's tiles as the forward
// uses them (keys as rows, P^T is the C fragment of qk_tile(K, Q)).  At
// head dims above 128 the dK and dV accumulators do not both fit one
// thread's registers, so the CTAs of one launch split: half accumulate dK,
// half dV, each walking the tiles (the f32 route keeps the walk twice).
//
// Masks: causal, sliding window, non-causal, and Sq != Sk (cross
// attention, non-causal).  Query i sits at position i (q_offset 0) and every
// key is valid: the wrapper refuses q_offset and kv_valid_len for the
// backward, which only decode uses.  kernels/flash_attention.py::bwd_plan
// mirrors the launch choices below (route, warpgroups, tiles, stages,
// shared memory, launches).
#include <cuda_bf16.h>
#include <stdint.h>

#include <math.h>

#include "attention.cuh"
#include "attention_bwd.cuh"
#include "dtype.cuh"
#include "kernels.h"
#include "mma.cuh"

namespace repro {
namespace {

// D_i = sum_c dO_ic O_ic, a warp a row; rows in O's order (b, q, h)
template <typename T>
__global__ void __launch_bounds__(kThreads) delta_kernel(AttnBwdArgs a) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<long long>(a.B) * a.Sq * a.H) return;  // the warp
  const T* o = static_cast<const T*>(a.o) + row * a.Dv;
  const T* g = static_cast<const T*>(a.dout) + row * a.Dv;
  float s = 0.f;
  for (int c = lane; c < a.Dv; c += 32) s += to_f32(o[c]) * to_f32(g[c]);
  s = warp_sum(s);
  if (lane == 0) {
    const int h = static_cast<int>(row % a.H);
    const long long bq = row / a.H;
    const int qi = static_cast<int>(bq % a.Sq);
    const long long b = bq / a.Sq;
    a.delta[(b * a.H + h) * a.Sq + qi] = s;
  }
}

// ======================================================= f32: mma.sync
constexpr int kBwdBK = 32;          // queries (dK / dV) or keys (dQ) a tile

// 64 rows of the CTA's own operands and kBwdBK rows of the walked ones, at
// the strides qk_tile reads (K and Q at D's, V and dO at Dv's), and the
// walked queries' lse and delta
template <typename T>
size_t bwd_smem_bytes(int dp, int dvp) {
  return sizeof(T) * static_cast<size_t>(kBQ + kBwdBK) *
             (qk_stride<T>(dp) + qk_stride<T>(dvp)) +
         2 * kBwdBK * sizeof(float);
}

// the dK (WHICH & kDK) and dV (WHICH & kDV) of key tile `kt` of batch `b`
template <typename T, int DP, int DV, int WHICH>
__device__ __forceinline__ void dkdv_tile(const AttnBwdArgs& a, int vec,
                                          int kt, int b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ k = static_cast<const T*>(a.k);
  const T* __restrict__ v = static_cast<const T*>(a.v);
  const T* __restrict__ dout = static_cast<const T*>(a.dout);
  const int D = a.D;
  const int Dv = a.Dv;
  const int dp = pad16(D);
  const int dvp = pad16(Dv);
  const int QS = qk_stride<T>(dp);
  const int VS = qk_stride<T>(dvp);
  T* ks = reinterpret_cast<T*>(smem_raw);   // kBQ keys
  T* vs = ks + kBQ * QS;                    // their values
  T* qs = vs + kBQ * VS;                    // kBwdBK queries
  T* dos = qs + kBwdBK * QS;                // their output gradients
  float* lse2 = reinterpret_cast<float*>(dos + kBwdBK * VS);
  float* dlt = lse2 + kBwdBK;

  const int k0 = kt * kBQ;
  const int hk = blockIdx.y;
  const int G = a.H / a.Hkv;
  const int nk = min(kBQ, a.Sk - k0);
  const long long q_row = static_cast<long long>(a.H) * D;
  const long long o_row = static_cast<long long>(a.H) * Dv;
  const long long kv_row = static_cast<long long>(a.Hkv) * D;
  const long long v_row = static_cast<long long>(a.Hkv) * Dv;
  const T* kg = k + (static_cast<long long>(b) * a.Sk + k0) * kv_row +
                static_cast<long long>(hk) * D;
  const T* vg = v + (static_cast<long long>(b) * a.Sk + k0) * v_row +
                static_cast<long long>(hk) * Dv;

  if (dp > D) {
    zero_pad(ks, QS, kBQ, D, dp);
    zero_pad(qs, QS, kBwdBK, D, dp);
  }
  if (dvp > Dv) {
    zero_pad(vs, VS, kBQ, Dv, dvp);
    zero_pad(dos, VS, kBwdBK, Dv, dvp);
  }
  load_rows(ks, QS, kg, kv_row, nk, kBQ, D, vec);
  load_rows(vs, VS, vg, v_row, nk, kBQ, Dv, vec);
  cp_async_commit();
  cp_async_wait<0>();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int w_lo = warp * 16;                 // the warp's first key row
  const int w_rows = min(16, nk - w_lo);      // may be <= 0
  const int kw_lo = k0 + w_lo, kw_hi = kw_lo + w_rows - 1;
  const int kr0 = kw_lo + g, kr1 = kr0 + 8;   // this lane's keys
  const float scale_log2 = a.scale * kLog2e;

  float dk[DP / 8][4], dv[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) {
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  // the queries that see a key of the tile: [q_begin, q_end)
  int q_begin = a.causal ? k0 : 0;
  int q_end = a.Sq;
  if (a.window > 0) q_end = min(q_end, k0 + nk - 1 + a.window);
  q_begin = q_begin / kBwdBK * kBwdBK;

  for (int j = 0; j < G; ++j) {
    const int h = hk * G + j;
    const T* qg = q + static_cast<long long>(b) * a.Sq * q_row +
                  static_cast<long long>(h) * D;
    const T* dg = dout + static_cast<long long>(b) * a.Sq * o_row +
                  static_cast<long long>(h) * Dv;
    const long long stat = (static_cast<long long>(b) * a.H + h) * a.Sq;
    for (int q0 = q_begin; q0 < q_end; q0 += kBwdBK) {
      const int nq = min(kBwdBK, a.Sq - q0);
      load_rows(qs, QS, qg + q0 * q_row, q_row, nq, kBwdBK, D, vec);
      load_rows(dos, VS, dg + q0 * o_row, o_row, nq, kBwdBK, Dv, vec);
      cp_async_commit();
      for (int i = threadIdx.x; i < kBwdBK; i += kThreads) {
        lse2[i] = i < nq ? a.lse[stat + q0 + i] * kLog2e : 0.f;
        dlt[i] = i < nq ? a.delta[stat + q0 + i] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();

      // does a query of the tile see one of the warp's keys?
      bool live = w_rows > 0;
      if (a.causal) live = live && q0 + nq - 1 >= kw_lo;
      if (a.window > 0) live = live && q0 < kw_hi + a.window;
      if (live) {
        // S^T: rows the warp's keys, columns the tile's queries
        float s[kBwdBK / 8][4];
#pragma unroll
        for (int n = 0; n < kBwdBK / 8; ++n) {
          s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        }
        qk_tile<DP, kBwdBK>(s, ks + w_lo * QS, qs, QS, dp, g, t);
#pragma unroll
        for (int n = 0; n < kBwdBK / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ci = n * 8 + 2 * t + e;
            const int qj = q0 + ci;
            const float l2 = lse2[ci];
            s[n][e] = seen(a, qj, kr0) ? exp2f(s[n][e] * scale_log2 - l2)
                                       : 0.f;
            s[n][2 + e] = seen(a, qj, kr1)
                              ? exp2f(s[n][2 + e] * scale_log2 - l2)
                              : 0.f;
          }
        }
        if constexpr ((WHICH & kDV) != 0) {
          pv_tile<DV, kBwdBK>(dv, s, dos, VS, dvp, lane);   // dV += P^T dO
        }
        if constexpr ((WHICH & kDK) != 0) {
          float ds[kBwdBK / 8][4];
#pragma unroll
          for (int n = 0; n < kBwdBK / 8; ++n) {
            ds[n][0] = ds[n][1] = ds[n][2] = ds[n][3] = 0.f;
          }
          qk_tile<DV, kBwdBK>(ds, vs + w_lo * VS, dos, VS, dvp, g, t);
#pragma unroll
          for (int n = 0; n < kBwdBK / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float dl = dlt[n * 8 + 2 * t + e];
              ds[n][e] = s[n][e] * (ds[n][e] - dl);
              ds[n][2 + e] = s[n][2 + e] * (ds[n][2 + e] - dl);
            }
          }
          pv_tile<DP, kBwdBK>(dk, ds, qs, QS, dp, lane);   // dK += dS^T Q
        }
      }
      __syncthreads();   // the tiles are refilled
    }
  }

  T* dk0 = static_cast<T*>(a.dk) +
           (static_cast<long long>(b) * a.Sk + kr0) * kv_row +
           static_cast<long long>(hk) * D;
  T* dv0 = static_cast<T*>(a.dv) +
           (static_cast<long long>(b) * a.Sk + kr0) * v_row +
           static_cast<long long>(hk) * Dv;
  if constexpr ((WHICH & kDK) != 0) {
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n * 8 + 2 * t + e;
        if (c < D) {
          if (g < w_rows) dk0[c] = from_f32<T>(dk[n][e] * a.scale);
          if (g + 8 < w_rows) {
            dk0[8 * kv_row + c] = from_f32<T>(dk[n][2 + e] * a.scale);
          }
        }
      }
    }
  }
  if constexpr ((WHICH & kDV) != 0) {
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n * 8 + 2 * t + e;
        if (c < Dv) {
          if (g < w_rows) dv0[c] = from_f32<T>(dv[n][e]);
          if (g + 8 < w_rows) dv0[8 * v_row + c] = from_f32<T>(dv[n][2 + e]);
        }
      }
    }
  }
}

// head dims up to 128: dK and dV of key tile blockIdx.x
template <typename T, int DP, int DV>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(AttnBwdArgs a, int vec) {
  dkdv_tile<T, DP, DV, kDK | kDV>(a, vec, blockIdx.x, blockIdx.z);
}

// above: the CTAs of the grid's first B z-slices compute dK, those of the
// next B dV, so every dK CTA starts before any dV one, in the order two
// passes would run them (each branch holds one accumulator, so the
// registers are the larger branch's)
template <typename T, int DP, int DV>
__global__ void __launch_bounds__(kThreads)
    dkdv_split_kernel(AttnBwdArgs a, int vec) {
  if (static_cast<int>(blockIdx.z) < a.B) {
    dkdv_tile<T, DP, DV, kDK>(a, vec, blockIdx.x, blockIdx.z);
  } else {
    dkdv_tile<T, DP, DV, kDV>(a, vec, blockIdx.x, blockIdx.z - a.B);
  }
}

template <typename T, int DP, int DV>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(AttnBwdArgs a, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ k = static_cast<const T*>(a.k);
  const T* __restrict__ v = static_cast<const T*>(a.v);
  const T* __restrict__ dout = static_cast<const T*>(a.dout);
  const int D = a.D;
  const int Dv = a.Dv;
  const int dp = pad16(D);
  const int dvp = pad16(Dv);
  const int QS = qk_stride<T>(dp);
  const int VS = qk_stride<T>(dvp);
  T* qs = reinterpret_cast<T*>(smem_raw);   // kBQ queries
  T* dos = qs + kBQ * QS;                   // their output gradients
  T* ks = dos + kBQ * VS;                   // kBwdBK keys
  T* vs = ks + kBwdBK * QS;                 // their values

  // the last query blocks see the most keys: start them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int rows = min(kBQ, a.Sq - q0);
  int k_end = a.Sk;
  if (a.causal) k_end = min(k_end, q0 + rows);
  int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  k_begin = k_begin / kBwdBK * kBwdBK;

  const long long q_row = static_cast<long long>(a.H) * D;
  const long long o_row = static_cast<long long>(a.H) * Dv;
  const long long kv_row = static_cast<long long>(a.Hkv) * D;
  const long long v_row = static_cast<long long>(a.Hkv) * Dv;
  const T* kg = k + static_cast<long long>(b) * a.Sk * kv_row +
                static_cast<long long>(hk) * D;
  const T* vg = v + static_cast<long long>(b) * a.Sk * v_row +
                static_cast<long long>(hk) * Dv;

  if (dp > D) {
    zero_pad(qs, QS, kBQ, D, dp);
    zero_pad(ks, QS, kBwdBK, D, dp);
  }
  if (dvp > Dv) {
    zero_pad(dos, VS, kBQ, Dv, dvp);
    zero_pad(vs, VS, kBwdBK, Dv, dvp);
  }
  load_rows(qs, QS,
            q + (static_cast<long long>(b) * a.Sq + q0) * q_row +
                static_cast<long long>(h) * D,
            q_row, rows, kBQ, D, vec);
  load_rows(dos, VS,
            dout + (static_cast<long long>(b) * a.Sq + q0) * o_row +
                static_cast<long long>(h) * Dv,
            o_row, rows, kBQ, Dv, vec);
  cp_async_commit();
  cp_async_wait<0>();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int w_lo = warp * 16;                 // the warp's first query row
  const int w_rows = min(16, rows - w_lo);    // may be <= 0
  const int wq_lo = q0 + w_lo, wq_hi = wq_lo + w_rows - 1;
  const int qr0 = wq_lo + g, qr1 = qr0 + 8;   // this lane's queries
  const long long stat = (static_cast<long long>(b) * a.H + h) * a.Sq;
  const float l0 = g < w_rows ? a.lse[stat + qr0] * kLog2e : 0.f;
  const float l1 = g + 8 < w_rows ? a.lse[stat + qr1] * kLog2e : 0.f;
  const float d0 = g < w_rows ? a.delta[stat + qr0] : 0.f;
  const float d1 = g + 8 < w_rows ? a.delta[stat + qr1] : 0.f;
  const float scale_log2 = a.scale * kLog2e;

  float dq[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBwdBK) {
    const int nk = min(kBwdBK, a.Sk - k0);
    load_rows(ks, QS, kg + k0 * kv_row, kv_row, nk, kBwdBK, D, vec);
    load_rows(vs, VS, vg + k0 * v_row, v_row, nk, kBwdBK, Dv, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // does any of the warp's rows see a key of this tile?
    bool live = w_rows > 0;
    if (a.causal) live = live && k0 <= wq_hi;
    if (a.window > 0) live = live && k0 + kBwdBK - 1 > wq_lo - a.window;
    if (live) {
      float s[kBwdBK / 8][4], ds[kBwdBK / 8][4];
#pragma unroll
      for (int n = 0; n < kBwdBK / 8; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        ds[n][0] = ds[n][1] = ds[n][2] = ds[n][3] = 0.f;
      }
      qk_tile<DP, kBwdBK>(s, qs + w_lo * QS, ks, QS, dp, g, t);
      qk_tile<DV, kBwdBK>(ds, dos + w_lo * VS, vs, VS, dvp, g, t);
#pragma unroll
      for (int n = 0; n < kBwdBK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = k0 + n * 8 + 2 * t + e;
          const float p0 =
              seen(a, qr0, kj) ? exp2f(s[n][e] * scale_log2 - l0) : 0.f;
          const float p1 =
              seen(a, qr1, kj) ? exp2f(s[n][2 + e] * scale_log2 - l1) : 0.f;
          ds[n][e] = p0 * (ds[n][e] - d0);
          ds[n][2 + e] = p1 * (ds[n][2 + e] - d1);
        }
      }
      pv_tile<DP, kBwdBK>(dq, ds, ks, QS, dp, lane);   // dQ += dS K
    }
    __syncthreads();   // the tiles are refilled
  }

  T* dq0 = static_cast<T*>(a.dq) +
           (static_cast<long long>(b) * a.Sq + qr0) * q_row +
           static_cast<long long>(h) * D;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = n * 8 + 2 * t + e;
      if (c < D) {
        if (g < w_rows) dq0[c] = from_f32<T>(dq[n][e] * a.scale);
        if (g + 8 < w_rows) {
          dq0[8 * q_row + c] = from_f32<T>(dq[n][2 + e] * a.scale);
        }
      }
    }
  }
}

// dK / dV (one launch: a kernel for both up to a head dim of 128, half the
// CTAs each past it), then dQ
template <int DP, int DV>
cudaError_t launch_bwd_f32(const AttnBwdArgs& a, int vec,
                           cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<float>(pad16(a.D), pad16(a.Dv));
  cudaError_t err = cudaSuccess;
  if (a.Sk > 0) {
    const int tiles = (a.Sk + kBQ - 1) / kBQ;
    if constexpr (DP <= 128) {
      err = allow_smem<dkdv_kernel<float, DP, DV>>(smem);
      if (err != cudaSuccess) return err;
      dkdv_kernel<float, DP, DV><<<dim3(tiles, a.Hkv, a.B), kThreads, smem,
                                   stream>>>(a, vec);
    } else {
      err = allow_smem<dkdv_split_kernel<float, DP, DV>>(smem);
      if (err != cudaSuccess) return err;
      dkdv_split_kernel<float, DP, DV>
          <<<dim3(tiles, a.Hkv, 2 * a.B), kThreads, smem, stream>>>(a, vec);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (a.Sq > 0) {
    err = allow_smem<dq_kernel<float, DP, DV>>(smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
    dq_kernel<float, DP, DV><<<grid, kThreads, smem, stream>>>(a, vec);
    err = cudaGetLastError();
  }
  return err;
}

template <typename T>
cudaError_t launch_bwd_typed(const AttnBwdArgs& a, cudaStream_t stream) {
  const size_t es = sizeof(T);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = (a.D * es) % 16 == 0 && (a.Dv * es) % 16 == 0 &&
                  aligned(a.q) && aligned(a.k) && aligned(a.v) &&
                  aligned(a.dout);
  if (a.Sq > 0) {
    const long long rows = static_cast<long long>(a.B) * a.Sq * a.H;
    const long long ctas = (rows + kThreads / 32 - 1) / (kThreads / 32);
    delta_kernel<T><<<static_cast<unsigned>(ctas), kThreads, 0, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if constexpr (sizeof(T) == 2) {
    return launch_flash_attention_bwd_wgmma(a, vec, stream);
  } else {
    const int dp = pad16(a.D);
    if (dp <= 64) return launch_bwd_f32<64, 64>(a, vec, stream);
    if (dp <= 96) return launch_bwd_f32<96, 96>(a, vec, stream);
    if (dp <= 128) return launch_bwd_f32<128, 128>(a, vec, stream);
    if (pad16(a.Dv) <= 128) return launch_bwd_f32<256, 128>(a, vec, stream);
    return launch_bwd_f32<256, 256>(a, vec, stream);
  }
}

}  // namespace

cudaError_t launch_flash_attention_bwd(const AttnBwdArgs& a, int dtype,
                                       cudaStream_t stream) {
  if (a.D <= 0 || a.D > kMaxD || a.Dv <= 0 || a.Dv > a.D || a.Hkv <= 0 ||
      a.H % a.Hkv != 0 || a.lse == nullptr || a.delta == nullptr) {
    return cudaErrorInvalidValue;
  }
  if (a.B <= 0 || a.H <= 0) return cudaSuccess;
  if (dtype == kBF16) return launch_bwd_typed<__nv_bfloat16>(a, stream);
  if (dtype != kF32) return cudaErrorInvalidValue;
  return launch_bwd_typed<float>(a, stream);
}

}  // namespace repro
