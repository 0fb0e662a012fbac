// Online-softmax ("flash") attention with GQA, causal, sliding-window and
// valid-length masks, in two variants: prefill on the tensor cores, and
// split-KV decode ("flash-decoding").  The wrapper
// (repro_torch/kernels/flash_attention.py::plan) picks the variant and the
// split count; AttnArgs::n_split == 0 means prefill.
//
// Replaces the Pallas kernel
// src/repro/kernels/flash_attention.py::_attn_kernel.  The TPU kernel walks
// KV blocks as the innermost, sequential grid axis and keeps the running
// (acc, m, l) in VMEM scratch between grid steps.  CUDA blocks run in no
// order, so here a CTA loops over its KV tiles itself.
//
// Prefill (bound by operations: 2 * (D + Dv) flops per visible (query, key)
// pair).
//   * A CTA of 4 warps takes 64 query rows of one (batch, head), 16 rows a
//     warp; the query blocks that see the most keys are started first.  KV
//     tiles of BK keys (bf16 64, f32 32: 3 CTAs an SM at D = 80, and Q with
//     two buffers fits at D = 256) are copied with cp.async into a ring of
//     two buffers, so the next tile loads while this one is computed.  Q
//     stays in shared memory to leave registers to the O accumulator.
//   * S = Q K^T and O += P V run as mma.sync (mma.cuh) with f32
//     accumulators: bf16 as m16n8k16, f32 as m16n8k8.tf32 in split TF32
//     (x = hi + lo, both TF32,
//     rounded with integer ops; each product hi*hi + hi*lo + lo*hi), which
//     keeps close to f32 accuracy at a third of the TF32 rate.  The softmax
//     scale (times log2 e) multiplies S in f32 and the softmax runs in
//     exp2 (the plain version scales q first and uses exp; the results
//     differ in the last bits).
//   * The online softmax runs on the accumulator fragments: a row lives in
//     the 4 lanes of a quad, its max comes from two shuffles and its sum
//     is kept per lane and reduced once at the end.  For bf16 the S
//     fragments of two key n-tiles are the A fragment of P V as they are
//     (FlashAttention-2).  For f32 the mma's k index is mapped to keys so
//     that the C fragment of S is P's A fragment as it is, and to head-dim
//     columns so that a lane reads its Q and K values with one 16-byte
//     load (see qk_tile / pv_tile).
//   * The head dim is a template bucket (64, 96, 128, 256) and is padded to
//     a multiple of 16 with zeros inside shared memory, so any D <= 256
//     works.  At D = 256 the O accumulator is 128 registers a thread: f32
//     takes 239 and bf16 255 registers, with no spill (`-Xptxas -v`, which
//     chip_smoke.py prints).
//   * V may be narrower than K (Dv <= D: MLA's values are 128 wide against
//     192-wide keys).  P V, the O accumulator and the output tile run over
//     Dv only, with V's rows in shared memory at V's own stride; the
//     accumulator takes a second bucket, 128 when D is in the 256 bucket
//     and Dv <= 128, else D's (columns past Dv are skipped at run time).
//   * Shared-memory rows are padded so that every fragment load of a warp
//     hits 32 banks (qk_stride / v_stride).
//   * Only the tiles between the window's left edge and min(kv_valid, last
//     query + 1) are visited; a warp skips a tile none of its rows sees,
//     and masks per element only on tiles at an edge.
//
// Decode (bound by bytes: each K / V row up to the last visible key once).
//   * Grid (n_split, Hkv, B).  One CTA serves all G = H / Hkv query heads
//     of its KV head and all Sq rows (G * Sq <= 16), so a K / V row is read
//     once per group, over one of n_split ranges of the visible keys; the
//     wrapper picks n_split for about 4 CTAs on each of the 132 SMs.
//   * Tiles of 32 keys are copied with cp.async, 16 bytes a thread with
//     neighbouring threads on neighbouring addresses (a D = 80 f32 row is 20
//     16-byte pieces), double-buffered.  The warps split the rows of a
//     tile's scores (a lane per key, 16-byte shared-memory reads), then a
//     warp per row updates (m, l) and the CTA combines P V over the tile
//     through shared memory, acc for one (row, column) per thread item.
//   * Each CTA writes (acc, m, l) of its rows to an f32 scratch; the
//     combine kernel rescales the splits to one max and writes the output
//     in q's type.
//
// A row with no visible key ends with l = 0 and is written as 0, as the
// Pallas kernel and layers.chunked_attention give.
//
// For training the prefill variant also writes each row's log-sum-exp
// (AttnArgs::lse), which flash_attention_bwd.cu reads; with lse null the
// kernel computes and writes exactly what it does without it.  The tile
// helpers both files use are in attention.cuh.
#include <cuda_bf16.h>
#include <stdint.h>

#include <math.h>

#include "attention.cuh"
#include "dtype.cuh"
#include "kernels.h"
#include "mma.cuh"

namespace repro {
namespace {

constexpr int kDecodeBK = 32;       // decode: keys per tile
constexpr int kDecodeRows = 16;     // decode: most G * Sq rows per CTA
constexpr int kMaxSplits = 256;     // decode: most KV ranges (the wrapper's)

// decode reads K rows 16 bytes a lane, 8 rows a phase (see attention.cuh
// for the prefill strides)
template <typename T>
__host__ __device__ constexpr int dec_k_stride(int dp) {
  return dp + (sizeof(T) == 4 ? 4 : 8);
}
__host__ __device__ constexpr int dec_v_stride(int dp) { return dp + 8; }

template <typename T>
size_t prefill_smem_bytes(int dp, int dvp, int bk) {
  return sizeof(T) * (static_cast<size_t>(kBQ) * qk_stride<T>(dp) +
                      2 * static_cast<size_t>(bk) *
                          (qk_stride<T>(dp) + v_stride<T>(dvp)));
}

template <typename T>
size_t decode_smem_bytes(int dp) {
  return sizeof(T) * 2 * kDecodeBK *
             static_cast<size_t>(dec_k_stride<T>(dp) + dec_v_stride(dp)) +
         sizeof(float) * (static_cast<size_t>(kDecodeRows) * dp +
                          kDecodeRows * kDecodeBK + 3 * kDecodeRows);
}

__device__ __forceinline__ bool key_seen(const AttnArgs& a, int kj, int qpos,
                                         int kv_lim) {
  return kj < kv_lim && (!a.causal || kj <= qpos) &&
         (a.window <= 0 || kj > qpos - a.window);
}

template <typename T, int DP, int DV, int BK>
__global__ void __launch_bounds__(kThreads)
    prefill_kernel(AttnArgs a, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ k = static_cast<const T*>(a.k);
  const T* __restrict__ v = static_cast<const T*>(a.v);
  T* __restrict__ o = static_cast<T*>(a.o);
  const int D = a.D;
  const int Dv = a.Dv;
  const int dp = pad16(D);
  const int dvp = pad16(Dv);
  const int QS = qk_stride<T>(dp);
  const int VS = v_stride<T>(dvp);
  T* qs = reinterpret_cast<T*>(smem_raw);   // kBQ rows
  T* ks = qs + kBQ * QS;                    // 2 buffers of BK rows
  T* vs = ks + 2 * BK * QS;                 // 2 buffers of BK rows

  // the last query blocks see the most keys: start them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int rows = min(kBQ, a.Sq - q0);
  const int q_lo = a.q_offset + q0;
  const int q_hi = q_lo + rows - 1;
  const int kv_lim = min(a.kv_valid, a.Sk);
  int k_end = kv_lim;
  if (a.causal) k_end = min(k_end, q_hi + 1);
  int k_begin = a.window > 0 ? max(0, q_lo - a.window + 1) : 0;
  k_begin = k_begin / BK * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  const long long q_row = static_cast<long long>(a.H) * D;
  const long long kv_row = static_cast<long long>(a.Hkv) * D;
  const long long v_row = static_cast<long long>(a.Hkv) * Dv;
  const long long o_row = static_cast<long long>(a.H) * Dv;
  const T* qg = q + (static_cast<long long>(b) * a.Sq + q0) * q_row +
                static_cast<long long>(h) * D;
  const T* kg = k + static_cast<long long>(b) * a.Sk * kv_row +
                static_cast<long long>(hk) * D;
  const T* vg = v + static_cast<long long>(b) * a.Sk * v_row +
                static_cast<long long>(hk) * Dv;

  if (dp > D) {
    zero_pad(qs, QS, kBQ, D, dp);
    zero_pad(ks, QS, 2 * BK, D, dp);
  }
  if (dvp > Dv) zero_pad(vs, VS, 2 * BK, Dv, dvp);
  load_rows(qs, QS, qg, q_row, rows, kBQ, D, vec);
  if (n_tiles > 0) {
    const int n = min(BK, k_end - k_begin);
    load_rows(ks, QS, kg + k_begin * kv_row, kv_row, n, BK, D, vec);
    load_rows(vs, VS, vg + k_begin * v_row, v_row, n, BK, Dv, vec);
  }
  cp_async_commit();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int w_lo = warp * 16;                       // warp's first row
  const int w_rows = min(16, rows - w_lo);          // may be <= 0
  const int wq_lo = q_lo + w_lo, wq_hi = wq_lo + w_rows - 1;
  const T* qw = qs + w_lo * QS;
  // scores in log2 units (m too), so each probability is one exp2
  const float scale_log2 = a.scale * 1.4426950408889634f;

  float acc[DV / 8][4];
  float m[2], l[2];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * BK;
    if (it + 1 < n_tiles) {
      const int k1 = k0 + BK;
      const int n = min(BK, k_end - k1);
      const int nb = (it + 1) & 1;
      load_rows(ks + nb * BK * QS, QS, kg + k1 * kv_row, kv_row, n, BK, D,
                vec);
      load_rows(vs + nb * BK * VS, VS, vg + k1 * v_row, v_row, n, BK, Dv,
                vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // does any of the warp's rows see a key of this tile?
    bool live = w_rows > 0;
    if (a.causal) live = live && k0 <= wq_hi;
    if (a.window > 0) live = live && k0 + BK - 1 > wq_lo - a.window;
    if (live) {
      const T* kt = ks + (it & 1) * BK * QS;
      const T* vt = vs + (it & 1) * BK * VS;
      float s[BK / 8][4];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      }
      qk_tile<DP, BK>(s, qw, kt, QS, dp, g, t);

      // every key of the tile seen by every row of the warp?
      bool full = w_rows == 16 && k0 + BK <= kv_lim;
      if (a.causal) full = full && k0 + BK - 1 <= wq_lo;
      if (a.window > 0) full = full && k0 > wq_hi - a.window;
      // this lane's rows: g and g + 8 of the warp
      const int qp0 = wq_lo + g, qp1 = qp0 + 8;
      const bool ok0 = g < w_rows, ok1 = g + 8 < w_rows;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v0 = s[n][e] * scale_log2;
          float v1 = s[n][2 + e] * scale_log2;
          if (!full) {
            const int kj = k0 + n * 8 + 2 * t + e;
            if (!(ok0 && key_seen(a, kj, qp0, kv_lim))) v0 = -INFINITY;
            if (!(ok1 && key_seen(a, kj, qp1, kv_lim))) v1 = -INFINITY;
          }
          s[n][e] = v0;
          s[n][2 + e] = v1;
          mx0 = fmaxf(mx0, v0);
          mx1 = fmaxf(mx1, v1);
        }
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
      const float ms0 = mn0 == -INFINITY ? 0.f : mn0;
      const float ms1 = mn1 == -INFINITY ? 0.f : mn1;
      const float c0 = m[0] == -INFINITY ? 0.f : exp2f(m[0] - ms0);
      const float c1 = m[1] == -INFINITY ? 0.f : exp2f(m[1] - ms1);
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // masked: exp2(-inf) = 0
          s[n][e] = exp2f(s[n][e] - ms0);
          s[n][2 + e] = exp2f(s[n][2 + e] - ms1);
          ps0 += s[n][e];
          ps1 += s[n][2 + e];
        }
      }
      // this lane's columns; the quad sums at the end
      l[0] = l[0] * c0 + ps0;
      l[1] = l[1] * c1 + ps1;
      m[0] = mn0;
      m[1] = mn1;
#pragma unroll
      for (int n = 0; n < DV / 8; ++n) {
        acc[n][0] *= c0;
        acc[n][1] *= c0;
        acc[n][2] *= c1;
        acc[n][3] *= c1;
      }
      pv_tile<DV, BK>(acc, s, vt, VS, dvp, lane);
    }
    __syncthreads();   // the buffer is refilled two tiles on
  }

  const float l0 = quad_sum(l[0]);
  const float l1 = quad_sum(l[1]);
  T* o0 = o + (static_cast<long long>(b) * a.Sq + q0 + w_lo + g) * o_row +
          static_cast<long long>(h) * Dv;
  T* o1 = o0 + 8 * o_row;
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = n * 8 + 2 * t + e;
      if (c < Dv) {
        if (g < w_rows) {
          o0[c] = from_f32<T>(l0 > 0.f ? acc[n][e] / l0 : 0.f);
        }
        if (g + 8 < w_rows) {
          o1[c] = from_f32<T>(l1 > 0.f ? acc[n][2 + e] / l1 : 0.f);
        }
      }
    }
  }
  // the rows' log-sum-exp for the backward: m is in log2 units of the
  // scaled scores, so ln(sum exp(scale * s)) = (m + log2 l) ln 2
  if (a.lse != nullptr && t == 0) {
    constexpr float kLn2 = 0.6931471805599453f;
    float* lr = a.lse + (static_cast<long long>(b) * a.H + h) * a.Sq + q0 +
                w_lo + g;
    if (g < w_rows) lr[0] = l0 > 0.f ? (m[0] + log2f(l0)) * kLn2 : INFINITY;
    if (g + 8 < w_rows) {
      lr[8] = l1 > 0.f ? (m[1] + log2f(l1)) * kLn2 : INFINITY;
    }
  }
}

// ---------------------------------------------------------------- decode
__device__ __forceinline__ float dot16(const float* q, const float* k) {
  const float4 x = *reinterpret_cast<const float4*>(q);
  const float4 y = *reinterpret_cast<const float4*>(k);
  return x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
}

// sum over 8 columns starting at d (q in f32, k of type T), in column order
__device__ __forceinline__ float dot_cols(const float* q, const float* k,
                                          int d) {
  return dot16(q + d, k + d) + dot16(q + d + 4, k + d + 4);
}
__device__ __forceinline__ float dot_cols(const float* q,
                                          const __nv_bfloat16* k, int d) {
  const uint4 raw = *reinterpret_cast<const uint4*>(k + d);
  const __nv_bfloat162* kp = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 kf = __bfloat1622float2(kp[i]);
    s += q[d + 2 * i] * kf.x + q[d + 2 * i + 1] * kf.y;
  }
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(AttnArgs a, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ k = static_cast<const T*>(a.k);
  const T* __restrict__ v = static_cast<const T*>(a.v);
  const int D = a.D;
  const int dp = pad16(D);
  const int KS = dec_k_stride<T>(dp);
  const int VS = dec_v_stride(dp);
  T* ks = reinterpret_cast<T*>(smem_raw);            // 2 x kDecodeBK rows
  T* vs = ks + 2 * kDecodeBK * KS;                    // 2 x kDecodeBK rows
  float* qf = reinterpret_cast<float*>(vs + 2 * kDecodeBK * VS);
  float* ps = qf + kDecodeRows * dp;                  // rows x keys
  float* ml = ps + kDecodeRows * kDecodeBK;           // m, l, corr per row

  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.H / a.Hkv;
  const int R = G * a.Sq;                             // row r: query r / G,
  const int tid = threadIdx.x;                        // head hk * G + r % G
  const int warp = tid >> 5, lane = tid & 31;
  const int kv_lim = min(a.kv_valid, a.Sk);

  // the keys any row sees, cut into n_split ranges
  int kb = a.window > 0 ? max(0, a.q_offset - a.window + 1) : 0;
  int ke = kv_lim;
  if (a.causal) ke = min(ke, a.q_offset + a.Sq);
  const int n_keys = max(ke - kb, 0);
  const int chunk = (n_keys + a.n_split - 1) / a.n_split;
  const int s_lo = kb + split * chunk;
  const int s_hi = min(ke, s_lo + chunk);
  const int n_tiles = s_hi > s_lo ? (s_hi - s_lo + kDecodeBK - 1) / kDecodeBK
                                  : 0;

  const long long kv_row = static_cast<long long>(a.Hkv) * D;
  const T* kg = k + static_cast<long long>(b) * a.Sk * kv_row +
                static_cast<long long>(hk) * D;
  const T* vg = v + (kg - k);

  for (int i = tid; i < R * dp; i += kThreads) {
    const int r = i / dp;
    const int d = i - r * dp;
    float val = 0.f;
    if (d < D) {
      const long long off =
          ((static_cast<long long>(b) * a.Sq + r / G) * a.H + hk * G + r % G) *
              D + d;
      val = to_f32(q[off]) * a.scale;
    }
    qf[i] = val;
  }
  if (tid < R) {
    ml[tid] = -INFINITY;
    ml[kDecodeRows + tid] = 0.f;
  }
  if (dp > D) {
    zero_pad(ks, KS, 2 * kDecodeBK, D, dp);
    zero_pad(vs, VS, 2 * kDecodeBK, D, dp);
  }
  if (n_tiles > 0) {
    const int n = min(kDecodeBK, s_hi - s_lo);
    load_rows(ks, KS, kg + s_lo * kv_row, kv_row, n, kDecodeBK, D, vec);
    load_rows(vs, VS, vg + s_lo * kv_row, kv_row, n, kDecodeBK, D, vec);
  }
  cp_async_commit();

  constexpr int kItems = kDecodeRows * kMaxD / kThreads;   // 32
  float acc[kItems];
#pragma unroll
  for (int c = 0; c < kItems; ++c) acc[c] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = s_lo + it * kDecodeBK;
    if (it + 1 < n_tiles) {
      const int k1 = k0 + kDecodeBK;
      const int n = min(kDecodeBK, s_hi - k1);
      const int nb = (it + 1) & 1;
      load_rows(ks + nb * kDecodeBK * KS, KS, kg + k1 * kv_row, kv_row, n,
                kDecodeBK, D, vec);
      load_rows(vs + nb * kDecodeBK * VS, VS, vg + k1 * kv_row, kv_row, n,
                kDecodeBK, D, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kt = ks + (it & 1) * kDecodeBK * KS;
    const T* vt = vs + (it & 1) * kDecodeBK * VS;

    // scores: a lane per key, the warps split the rows
    const int kj = k0 + lane;
    for (int r = warp; r < R; r += kThreads / 32) {
      float sdot = 0.f;
      const float* qr = qf + r * dp;
      const T* kr = kt + lane * KS;
      for (int d = 0; d < dp; d += 8) sdot += dot_cols(qr, kr, d);
      const bool seen = kj < s_hi && key_seen(a, kj, a.q_offset + r / G,
                                              kv_lim);
      ps[r * kDecodeBK + lane] = seen ? sdot : -INFINITY;
    }
    __syncthreads();
    // online softmax: a warp per row
    for (int r = warp; r < R; r += kThreads / 32) {
      const float sv = ps[r * kDecodeBK + lane];
      const float m_old = ml[r];
      const float m_new = fmaxf(m_old, warp_max(sv));
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float p = expf(sv - m_safe);
      ps[r * kDecodeBK + lane] = p;
      const float psum = warp_sum(p);
      if (lane == 0) {
        const float corr = m_old == -INFINITY ? 0.f : expf(m_old - m_safe);
        ml[r] = m_new;
        ml[kDecodeRows + r] = ml[kDecodeRows + r] * corr + psum;
        ml[2 * kDecodeRows + r] = corr;
      }
    }
    __syncthreads();
    // acc = acc * corr + P V, one (row, column) per item
#pragma unroll
    for (int c = 0; c < kItems; ++c) {
      const int i = tid + c * kThreads;
      if (i < R * dp) {
        const int r = i / dp;
        const int d = i - r * dp;
        const float* pr = ps + r * kDecodeBK;
        float sum = 0.f;
#pragma unroll 8
        for (int j = 0; j < kDecodeBK; ++j) {
          sum += pr[j] * to_f32(vt[j * VS + d]);
        }
        acc[c] = acc[c] * ml[2 * kDecodeRows + r] + sum;
      }
    }
    __syncthreads();   // the buffer is refilled two tiles on
  }

  // (acc, m, l) of each row for this split
#pragma unroll
  for (int c = 0; c < kItems; ++c) {
    const int i = tid + c * kThreads;
    if (i < R * dp) {
      const int r = i / dp;
      const int d = i - r * dp;
      if (d < D) {
        const long long row =
            (static_cast<long long>(b) * a.H + hk * G + r % G) * a.Sq + r / G;
        a.scratch[(row * a.n_split + split) * (D + 2) + d] = acc[c];
      }
    }
  }
  if (tid < R) {
    const long long row =
        (static_cast<long long>(b) * a.H + hk * G + tid % G) * a.Sq + tid / G;
    float* part = a.scratch + (row * a.n_split + split) * (D + 2);
    part[D] = ml[tid];
    part[D + 1] = ml[kDecodeRows + tid];
  }
}

// One CTA per output row (b, s, h): rescale the splits to one max, sum.
// The splits' weights go through shared memory, so each thread's column
// loop issues independent loads.
template <typename T>
__global__ void __launch_bounds__(kThreads) combine_kernel(AttnArgs a) {
  __shared__ float w[kMaxSplits];
  __shared__ float red[kThreads / 32];
  const int row = blockIdx.x;
  const int h = row % a.H;
  const int s = (row / a.H) % a.Sq;
  const int b = row / (a.H * a.Sq);
  const int D = a.D;
  const int tid = threadIdx.x;
  const float* part =
      a.scratch + ((static_cast<long long>(b) * a.H + h) * a.Sq + s) *
                      a.n_split * (D + 2);
  float m = -INFINITY;
  for (int i = tid; i < a.n_split; i += kThreads) {
    m = fmaxf(m, part[i * (D + 2) + D]);
  }
  m = warp_max(m);
  if ((tid & 31) == 0) red[tid >> 5] = m;
  __syncthreads();
  m = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
  float l = 0.f;
  for (int i = tid; i < a.n_split; i += kThreads) {
    const float mi = part[i * (D + 2) + D];
    const float wi = mi == -INFINITY ? 0.f : expf(mi - m);
    w[i] = wi;
    l += wi * part[i * (D + 2) + D + 1];
  }
  l = warp_sum(l);
  __syncthreads();   // w written; red read
  if ((tid & 31) == 0) red[tid >> 5] = l;
  __syncthreads();
  l = (red[0] + red[1]) + (red[2] + red[3]);
  T* out = static_cast<T*>(a.o) + static_cast<long long>(row) * D;
  for (int d = tid; d < D; d += kThreads) {
    float sum = 0.f;
#pragma unroll 4
    for (int i = 0; i < a.n_split; ++i) sum += w[i] * part[i * (D + 2) + d];
    out[d] = from_f32<T>(l > 0.f ? sum / l : 0.f);
  }
}

// --------------------------------------------------------------- launch
template <typename T, int DP, int DV, int BK>
cudaError_t launch_prefill(const AttnArgs& a, int vec, cudaStream_t stream) {
  const size_t smem = prefill_smem_bytes<T>(pad16(a.D), pad16(a.Dv), BK);
  cudaError_t err = allow_smem<prefill_kernel<T, DP, DV, BK>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
  prefill_kernel<T, DP, DV, BK><<<grid, kThreads, smem, stream>>>(a, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const AttnArgs& a, cudaStream_t stream) {
  const size_t es = sizeof(T);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = (a.D * es) % 16 == 0 && (a.Dv * es) % 16 == 0 &&
                  aligned(a.q) && aligned(a.k) && aligned(a.v);
  if (a.n_split > 0) {
    const size_t smem = decode_smem_bytes<T>(pad16(a.D));
    cudaError_t err = allow_smem<decode_kernel<T>>(smem);
    if (err != cudaSuccess) return err;
    decode_kernel<T><<<dim3(a.n_split, a.Hkv, a.B), kThreads, smem, stream>>>(
        a, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    combine_kernel<T><<<a.B * a.Sq * a.H, kThreads, 0, stream>>>(a);
    return cudaGetLastError();
  }
  // f32 takes 32-key tiles: Q and two K / V buffers fit at D = 256
  constexpr int BK = sizeof(T) == 4 ? 32 : 64;
  const int dp = pad16(a.D);
  if (dp <= 64) return launch_prefill<T, 64, 64, BK>(a, vec, stream);
  if (dp <= 96) return launch_prefill<T, 96, 96, BK>(a, vec, stream);
  if (dp <= 128) return launch_prefill<T, 128, 128, BK>(a, vec, stream);
  if (pad16(a.Dv) <= 128) {
    return launch_prefill<T, 256, 128, BK>(a, vec, stream);
  }
  return launch_prefill<T, 256, 256, BK>(a, vec, stream);
}

}  // namespace

cudaError_t launch_flash_attention(const AttnArgs& a, int dtype,
                                   cudaStream_t stream) {
  if (a.D <= 0 || a.D > kMaxD || a.Dv <= 0 || a.Dv > a.D || a.Hkv <= 0 ||
      a.H % a.Hkv != 0 || a.n_split < 0) {
    return cudaErrorInvalidValue;
  }
  // the decode variant reads V at K's width and gives no log-sum-exp
  if (a.n_split > kMaxSplits ||
      (a.n_split > 0 &&
       (a.scratch == nullptr || (a.H / a.Hkv) * a.Sq > kDecodeRows ||
        a.Dv != a.D || a.lse != nullptr))) {
    return cudaErrorInvalidValue;
  }
  if (a.B <= 0 || a.Sq <= 0 || a.H <= 0) return cudaSuccess;
  if (dtype == kBF16) return launch_typed<__nv_bfloat16>(a, stream);
  if (dtype != kF32) return cudaErrorInvalidValue;
  return launch_typed<float>(a, stream);
}

}  // namespace repro
