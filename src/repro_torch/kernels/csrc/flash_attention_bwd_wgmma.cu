// The bf16 kernels of the attention backward, dK / dV and dQ on Hopper's
// warpgroup products (wgmma.cuh); flash_attention_bwd.cu has the function,
// its bound, the delta pass, the f32 route and the entry point.  Tiles sit
// in a ring of two shared-memory slots that cp.async fills one tile ahead
// of the products, in the 128-byte swizzle wgmma reads, every tile
// zero-padded to a multiple of 64 columns:
//   * dK / dV, head dims up to 128: a CTA is one warpgroup owning 64 keys
//     and walking 64-query tiles (Q, dO, lse, delta).  Keys as rows: S^T =
//     K Q^T and dP^T = V dO^T take both operands from shared memory; dV +=
//     P^T dO and dK += dS^T Q take P^T and dS^T from registers (the f32
//     fragments of S^T and dP^T, rounded to bf16, as the forward rounds
//     P), with Q and dO read MN-major from the same tiles.
//   * dK / dV, head dims above 128: the dK and dV accumulators of 64 keys
//     do not fit one warpgroup's registers, so two warpgroups share the 64
//     keys: each computes S^T and dP^T for 32 of the tile's queries, they
//     stage P^T and dS^T in shared memory, and then the first accumulates
//     dK, the second dV, both over the whole tile.  (Splitting dK and dV
//     by head-dim columns instead would cut 192 into halves of 96, which
//     are no whole 64-column swizzle atoms.)  One walk at every head dim.
//   * dQ: one warpgroup owns 64 queries and walks 32-key tiles: S and dP
//     from shared memory, dQ += dS K from registers with K read MN-major.
// Both grids put the tile index in z, so the longest walks (causal: the
// first key tiles, the last query blocks) start first across every head.
// Chosen by device time on an H100 (variants built side by side, timed in
// one process): at internvl2's call (4 x 512, 16 / 8 heads of 128,
// causal) one group of 64 keys a CTA, two CTAs an SM, beat two groups of
// 64 sharing one ring of query tiles, and 32-key dQ tiles (more CTAs an
// SM) beat 64-key ones.  Tried and dropped: a third ring slot (no
// measurable gain, and it halves the CTAs an SM), splitting a key tile's
// walk between two groups summed in shared memory (faster at internvl2's
// call, slower at whisper's cross attention), Q and dO held in registers
// for dQ's products, and interleaving the S and dP chains (no gain).
// What bounds the kernels at these sizes is not the tensor cores: with a
// phase cut out at a time, the copies, the exponentials and the products
// each took a like share of a tile's time (PERF.md, row 4b).
#include <cuda_bf16.h>
#include <stdint.h>

#include <math.h>

#include "attention.cuh"
#include "attention_bwd.cuh"
#include "dtype.cuh"
#include "kernels.h"
#include "mma.cuh"
#include "wgmma.cuh"

namespace repro {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kStages = 2;          // ring slots
constexpr int kWgRows = 64;         // a warpgroup's rows (wgmma's M)

__host__ __device__ constexpr int pad64(int d) { return (d + 63) / 64 * 64; }

// dK / dV: up to a head dim of 128 one warpgroup owns the CTA's 64 keys;
// above, two share them (split)
template <int DP>
__host__ __device__ constexpr bool kv_split() {
  return DP > 128;
}
template <int DP>
__host__ __device__ constexpr int kv_threads() {
  return kv_split<DP>() ? 256 : 128;
}
// a ring slot: 64 queries of Q and dO, then their lse and delta, padded so
// that the next slot starts on a 1,024-byte boundary
template <int DP, int DV>
__host__ __device__ constexpr int kv_slot_bytes() {
  return 2 * kWgRows * (DP + DV) + 1024;
}
// the 1,024 bytes of slack align the base; then K and V (the CTA's keys),
// the ring, and (split) P^T and dS^T of one tile
template <int DP, int DV>
__host__ __device__ constexpr size_t kv_smem_bytes() {
  return 1024 + 2 * kWgRows * (DP + DV) + kStages * kv_slot_bytes<DP, DV>() +
         (kv_split<DP>() ? 2 * 2 * kWgRows * kWgRows : 0);
}
// dQ: 64 queries of Q and dO, then the ring of 32-key tiles of K and V
constexpr int kDqKeys = 32;
template <int DP, int DV>
__host__ __device__ constexpr size_t dq_smem_bytes() {
  return 1024 + 2 * kWgRows * (DP + DV) + kStages * 2 * kDqKeys * (DP + DV);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

// a named barrier over the first n threads of the CTA
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// Rows [0, n) of a swizzled tile of ROWS rows and W columns (wg::swz): row
// j from src + j * stride, columns [0, D) (16-byte cp.async pieces when
// `vec`, else element copies); rows [n, ROWS) as zeros.  NT threads take
// part.  A thread takes one 16-byte column piece of every chunk and the
// rows j0, j0 + NT / 8, ...: NT / 8 is a multiple of 8, so the piece's
// swizzled place is the same in each of its rows and every offset but
// the first is a constant.
template <int NT, int ROWS, int W>
__device__ __forceinline__ void load_swz(bf16* dst, const bf16* src,
                                         long long stride, int n, int D,
                                         bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int R = NT / 8;   // rows a pass
    static_assert(R % 8 == 0 && ROWS % R == 0, "passes of whole 8-row groups");
    const int j0 = tid >> 3, c0 = (tid & 7) * 8;
    bf16* d0 = dst + j0 * 64 + ((c0 >> 3) ^ (j0 & 7)) * 8;
    const bf16* s0 = src + j0 * stride + c0;
#pragma unroll
    for (int ch = 0; ch < W / 64; ++ch) {
      if (ch * 64 + c0 < D) {
#pragma unroll
        for (int p = 0; p < ROWS / R; ++p) {
          bf16* d = d0 + ch * ROWS * 64 + p * R * 64;
          if (j0 + p * R < n) {
            cp_async16(d, s0 + p * R * stride + ch * 64);
          } else {
            *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
          }
        }
      }
    }
  } else {
    for (int i = tid; i < ROWS * D; i += NT) {
      const int j = i / D;
      const int c = i - j * D;
      dst[wg::swz(j, c, ROWS)] =
          j < n ? src[j * stride + c] : from_f32<bf16>(0.f);
    }
  }
}

// 2^x in one instruction (ex2.approx, relative error ~2^-22): the scores'
// exponent, whose result is rounded to bf16 for the products
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// columns [D, W) of a swizzled tile, as zeros (loads never write them)
template <int NT>
__device__ __forceinline__ void zero_cols(bf16* dst, int rows, int D, int W) {
  const int w = W - D;
  for (int i = threadIdx.x; i < rows * w; i += NT) {
    const int j = i / w;
    dst[wg::swz(j, D + i - j * w, rows)] = from_f32<bf16>(0.f);
  }
}

// the bf16 A fragment of columns 16 kk .. 16 kk + 15 of a D fragment
template <int R>
__device__ __forceinline__ void a_frag(uint32_t (&f)[4], const float (&d)[R],
                                       int kk) {
  f[0] = pack_f32(d[8 * kk], d[8 * kk + 1]);
  f[1] = pack_f32(d[8 * kk + 2], d[8 * kk + 3]);
  f[2] = pack_f32(d[8 * kk + 4], d[8 * kk + 5]);
  f[3] = pack_f32(d[8 * kk + 6], d[8 * kk + 7]);
}

// rows r0 and r0 + 8 (when < valid) of a D fragment of N columns, scaled,
// at dst + row * stride + column for columns < D
template <int N>
__device__ __forceinline__ void store_rows(bf16* dst, long long stride,
                                           const float (&d)[N / 2], int r0,
                                           int valid, int D, float scale,
                                           int t) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r >= valid) continue;
      bf16* row = dst + r * stride;
      const int c = 8 * j + 2 * t;
      const float x = d[4 * j + 2 * h] * scale;
      const float y = d[4 * j + 2 * h + 1] * scale;
      if (c + 1 < D && (D & 1) == 0) {   // both in, 4-byte aligned
        *reinterpret_cast<uint32_t*>(row + c) = pack_f32(x, y);
      } else {
        if (c < D) row[c] = from_f32<bf16>(x);
        if (c + 1 < D) row[c + 1] = from_f32<bf16>(y);
      }
    }
  }
}

// One warpgroup's walk over the query tiles that see its CTA's 64 keys.
// ROLE: kDK | kDV (head dims up to 128: the CTA's one group accumulates
// both), or kDK / kDV (above: two groups share the keys, and this one
// accumulates the one).  Every thread of the CTA runs the loads; the
// ring's barrier (1) and the staging barrier (2) count all of them.
template <int DP, int DV, int ROLE>
__device__ __forceinline__ void dkdv_walk(const AttnBwdArgs& a, int vec,
                                          unsigned char* sm) {
  constexpr bool SPLIT = kv_split<DP>();
  constexpr int KT = kWgRows;
  constexpr int NT = kv_threads<DP>();
  constexpr int NS = SPLIT ? 32 : 64;     // the group's query columns
  constexpr int SLOT = kv_slot_bytes<DP, DV>();
  const int D = a.D, Dv = a.Dv;
  bf16* ks = reinterpret_cast<bf16*>(sm);           // KT x DP
  bf16* vs = ks + KT * DP;                          // KT x DV
  unsigned char* ring = reinterpret_cast<unsigned char*>(vs + KT * DV);
  bf16* pst = reinterpret_cast<bf16*>(ring + kStages * SLOT);   // P^T
  bf16* dst = pst + kWgRows * kWgRows;                          // dS^T

  const int tid = threadIdx.x;
  const int wgi = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // key tiles in z, so that the first (causal: the longest walks) start
  // first across every head
  const int k0 = blockIdx.z * KT;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int G = a.H / a.Hkv;
  const int nk = min(KT, a.Sk - k0);
  const int qc = SPLIT ? 32 * wgi : 0;         // its first query column
  const int k_hi = k0 + nk - 1;
  const int kr0 = k0 + 16 * warp + g, kr1 = kr0 + 8;   // this lane's keys
  const long long q_row = static_cast<long long>(a.H) * D;
  const long long o_row = static_cast<long long>(a.H) * Dv;
  const long long kv_row = static_cast<long long>(a.Hkv) * D;
  const long long v_row = static_cast<long long>(a.Hkv) * Dv;
  const bf16* q = static_cast<const bf16*>(a.q) +
                  static_cast<long long>(b) * a.Sq * q_row;
  const bf16* dout = static_cast<const bf16*>(a.dout) +
                     static_cast<long long>(b) * a.Sq * o_row;
  const float scale_log2 = a.scale * kLog2e;

  const auto qtile = [&](int s) {
    return reinterpret_cast<bf16*>(ring + s * SLOT);
  };
  const auto otile = [&](int s) { return qtile(s) + kWgRows * DP; };
  const auto lse_s = [&](int s) {
    return reinterpret_cast<float*>(otile(s) + kWgRows * DV);
  };

  if (DP > D) {
    zero_cols<NT>(ks, KT, D, DP);
    for (int s = 0; s < kStages; ++s) {
      zero_cols<NT>(qtile(s), kWgRows, D, DP);
    }
  }
  if (DV > Dv) {
    zero_cols<NT>(vs, KT, Dv, DV);
    for (int s = 0; s < kStages; ++s) {
      zero_cols<NT>(otile(s), kWgRows, Dv, DV);
    }
  }
  load_swz<NT, KT, DP>(ks,
               static_cast<const bf16*>(a.k) +
                   (static_cast<long long>(b) * a.Sk + k0) * kv_row +
                   static_cast<long long>(hk) * D,
               kv_row, nk, D, vec);
  load_swz<NT, KT, DV>(vs,
               static_cast<const bf16*>(a.v) +
                   (static_cast<long long>(b) * a.Sk + k0) * v_row +
                   static_cast<long long>(hk) * Dv,
               v_row, nk, Dv, vec);
  cp_async_commit();

  // the queries that see a key of the tile: [q_begin, q_end), each head
  // of the group in turn
  int q_begin = a.causal ? k0 : 0;
  int q_end = a.Sq;
  if (a.window > 0) q_end = min(q_end, k0 + nk - 1 + a.window);
  q_begin = q_begin / kWgRows * kWgRows;
  const int n_q = q_end > q_begin ? (q_end - q_begin + kWgRows - 1) / kWgRows
                                  : 0;
  const int total = G * n_q;
  // fill slot it % kStages with query tile `it`; one commit either way
  const auto fetch = [&](int it) {
    if (it < total) {
      const int j = it / n_q;
      const int q0 = q_begin + (it - j * n_q) * kWgRows;
      const int h = hk * G + j;
      const int nq = min(kWgRows, a.Sq - q0);
      const int s = it % kStages;
      load_swz<NT, kWgRows, DP>(qtile(s),
                   q + q0 * q_row + static_cast<long long>(h) * D, q_row, nq,
                   D, vec);
      load_swz<NT, kWgRows, DV>(otile(s),
                   dout + q0 * o_row + static_cast<long long>(h) * Dv, o_row,
                   nq, Dv, vec);
      if (tid < kWgRows) {
        float* ls = lse_s(s);
        const long long stat =
            (static_cast<long long>(b) * a.H + h) * a.Sq + q0 + tid;
        if (tid < nq) {
          cp_async4(ls + tid, a.lse + stat);
          cp_async4(ls + kWgRows + tid, a.delta + stat);
        } else {   // past the last query: P = 0 and dS = 0
          ls[tid] = INFINITY;
          ls[kWgRows + tid] = 0.f;
        }
      }
    }
    cp_async_commit();
  };

  for (int s = 0; s < kStages - 1; ++s) fetch(s);

  float dk[(ROLE & kDK) ? DP / 2 : 1], dv[(ROLE & kDV) ? DV / 2 : 1];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) {
    if constexpr ((ROLE & kDK) != 0) dk[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) {
    if constexpr ((ROLE & kDV) != 0) dv[i] = 0.f;
  }

  // descriptors of the group's keys and values, and of the staged P^T
  // and dS^T
  const uint64_t kd = wg::kdesc(ks), vd = wg::kdesc(vs);
  const uint64_t psd = wg::kdesc(pst), dsd = wg::kdesc(dst);
  for (int it = 0; it < total; ++it) {
    cp_async_wait<kStages - 2>();
    wg::fence_async();
    bar_sync(1, NT);   // tile `it` is in, and every group is done with it-1
    fetch(it + kStages - 1);
    const int s = it % kStages;
    const int j = it / n_q;
    const int q0 = q_begin + (it - j * n_q) * kWgRows;
    const int nq = min(kWgRows, a.Sq - q0);
    // does a query of the tile see one of the group's keys?  (Split: both
    // groups own the same keys, so they agree.)
    bool live = true;
    if (a.causal) live = q0 + nq - 1 >= k0;
    if (a.window > 0) live = live && q0 < k_hi + a.window;
    if (!live) continue;
    const bool masked = (a.causal && q0 < k_hi) ||
                        (a.window > 0 && q0 + kWgRows - 1 - a.window >= k0);
    const bf16* qt = qtile(s);
    const bf16* ot = otile(s);
    const float* ls = lse_s(s) + qc;
    const float* dl = ls + kWgRows;
    const uint64_t qd = wg::kdesc(qt + qc * 64), od = wg::kdesc(ot + qc * 64);
    const uint64_t qmn = wg::mndesc(qt, kWgRows);
    const uint64_t omn = wg::mndesc(ot, kWgRows);

    // S^T = K Q^T and dP^T = V dO^T: rows the group's keys, columns its
    // queries
    float sc[NS / 2], dp[NS / 2];
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wg::Mma<NS>::template ss<0>(sc, wg::kstep<KT>(kd, kk),
                                  wg::kstep<kWgRows>(qd, kk), kk);
    }
    wg::commit();
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk) {
      wg::Mma<NS>::template ss<0>(dp, wg::kstep<KT>(vd, kk),
                                  wg::kstep<kWgRows>(od, kk), kk);
    }
    wg::commit();
    wg::wait<1>();
    wg::pin(sc);
    // P^T = 2^(S^T scale log2 e - lse log2 e), a column a query
#pragma unroll
    for (int n = 0; n < NS / 8; ++n) {
      const float2 l = *reinterpret_cast<const float2*>(ls + 8 * n + 2 * t);
      const float l2[2] = {-l.x * kLog2e, -l.y * kLog2e};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[4 * n + e] = ex2(__fmaf_rn(sc[4 * n + e], scale_log2, l2[e & 1]));
      }
    }
    if (masked) {
#pragma unroll
      for (int n = 0; n < NS / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qj = q0 + qc + 8 * n + 2 * t + (e & 1);
          if (!seen(a, qj, e < 2 ? kr0 : kr1)) sc[4 * n + e] = 0.f;
        }
      }
    }
    wg::wait<0>();
    wg::pin(dp);
    // dS^T = P^T (dP^T - delta)
#pragma unroll
    for (int n = 0; n < NS / 8; ++n) {
      const float2 d = *reinterpret_cast<const float2*>(dl + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dp[4 * n + e] = sc[4 * n + e] * (dp[4 * n + e] - (e & 1 ? d.y : d.x));
      }
    }
    if constexpr (!SPLIT) {
      // dV += P^T dO and dK += dS^T Q, P^T and dS^T from registers
      uint32_t pf[NS / 16][4], df[NS / 16][4];
#pragma unroll
      for (int kk = 0; kk < NS / 16; ++kk) {
        a_frag(pf[kk], sc, kk);
        a_frag(df[kk], dp, kk);
      }
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < NS / 16; ++kk) {   // two chains, interleaved
        wg::Mma<DV>::template rs<1>(dv, pf[kk], wg::mnstep(omn, kk), 1);
        wg::Mma<DP>::template rs<1>(dk, df[kk], wg::mnstep(qmn, kk), 1);
      }
      wg::commit();
      wg::wait<0>();
      wg::pin(dv);
      wg::pin(dk);
    } else {
      // stage P^T and dS^T (the group's 32 columns), then one group takes
      // dK += dS^T Q, the other dV += P^T dO, over all 64 queries
      const int r0 = 16 * warp + g;
#pragma unroll
      for (int n = 0; n < NS / 8; ++n) {
        const int c = qc + 8 * n + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          *reinterpret_cast<uint32_t*>(pst + wg::swz(r, c, kWgRows)) =
              pack_f32(sc[4 * n + 2 * h], sc[4 * n + 2 * h + 1]);
          *reinterpret_cast<uint32_t*>(dst + wg::swz(r, c, kWgRows)) =
              pack_f32(dp[4 * n + 2 * h], dp[4 * n + 2 * h + 1]);
        }
      }
      wg::fence_async();
      bar_sync(2, NT);
      wg::fence();
      if constexpr (ROLE == kDK) {
#pragma unroll
        for (int kk = 0; kk < kWgRows / 16; ++kk) {
          wg::Mma<DP>::template ss<1>(dk, wg::kstep<kWgRows>(dsd, kk),
                                      wg::mnstep(qmn, kk), 1);
        }
        wg::commit();
        wg::wait<0>();
        wg::pin(dk);
      } else {
#pragma unroll
        for (int kk = 0; kk < kWgRows / 16; ++kk) {
          wg::Mma<DV>::template ss<1>(dv, wg::kstep<kWgRows>(psd, kk),
                                      wg::mnstep(omn, kk), 1);
        }
        wg::commit();
        wg::wait<0>();
        wg::pin(dv);
      }
    }
  }

  const int r0 = 16 * warp + g;
  if constexpr ((ROLE & kDK) != 0) {
    store_rows<DP>(static_cast<bf16*>(a.dk) +
                       (static_cast<long long>(b) * a.Sk + k0) * kv_row +
                       static_cast<long long>(hk) * D,
                   kv_row, dk, r0, nk, D, a.scale, t);
  }
  if constexpr ((ROLE & kDV) != 0) {
    store_rows<DV>(static_cast<bf16*>(a.dv) +
                       (static_cast<long long>(b) * a.Sk + k0) * v_row +
                       static_cast<long long>(hk) * Dv,
                   v_row, dv, r0, nk, Dv, 1.f, t);
  }
}

template <int DP, int DV>
__global__ void __launch_bounds__(kv_threads<DP>(), 1)
    dkdv_wg_kernel(AttnBwdArgs a, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  if constexpr (!kv_split<DP>()) {
    dkdv_walk<DP, DV, kDK | kDV>(a, vec, sm);
  } else if (threadIdx.x < 128) {
    dkdv_walk<DP, DV, kDK>(a, vec, sm);
  } else {
    dkdv_walk<DP, DV, kDV>(a, vec, sm);
  }
}

template <int DP, int DV>
__global__ void __launch_bounds__(128, 1) dq_wg_kernel(AttnBwdArgs a,
                                                       int vec) {
  constexpr int BK = kDqKeys;
  constexpr int NT = 128;
  constexpr int SLOT = 2 * BK * (DP + DV);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  const int D = a.D, Dv = a.Dv;
  bf16* qs = reinterpret_cast<bf16*>(sm);       // 64 x DP
  bf16* dos = qs + kWgRows * DP;                // 64 x DV
  unsigned char* ring = reinterpret_cast<unsigned char*>(dos + kWgRows * DV);
  const auto ktile = [&](int s) {
    return reinterpret_cast<bf16*>(ring + s * SLOT);
  };
  const auto vtile = [&](int s) { return ktile(s) + BK * DP; };

  // the last query blocks see the most keys: start them first, across
  // every head (query blocks in z)
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kWgRows;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int hk = h / (a.H / a.Hkv);
  const int rows = min(kWgRows, a.Sq - q0);
  int k_end = a.Sk;
  if (a.causal) k_end = min(k_end, q0 + rows);
  int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  k_begin = k_begin / BK * BK;
  const int total = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  const long long q_row = static_cast<long long>(a.H) * D;
  const long long o_row = static_cast<long long>(a.H) * Dv;
  const long long kv_row = static_cast<long long>(a.Hkv) * D;
  const long long v_row = static_cast<long long>(a.Hkv) * Dv;
  const bf16* kg = static_cast<const bf16*>(a.k) +
                   static_cast<long long>(b) * a.Sk * kv_row +
                   static_cast<long long>(hk) * D;
  const bf16* vg = static_cast<const bf16*>(a.v) +
                   static_cast<long long>(b) * a.Sk * v_row +
                   static_cast<long long>(hk) * Dv;

  if (DP > D) {
    zero_cols<NT>(qs, kWgRows, D, DP);
    for (int s = 0; s < kStages; ++s) zero_cols<NT>(ktile(s), BK, D, DP);
  }
  if (DV > Dv) {
    zero_cols<NT>(dos, kWgRows, Dv, DV);
    for (int s = 0; s < kStages; ++s) zero_cols<NT>(vtile(s), BK, Dv, DV);
  }
  load_swz<NT, kWgRows, DP>(qs,
               static_cast<const bf16*>(a.q) +
                   (static_cast<long long>(b) * a.Sq + q0) * q_row +
                   static_cast<long long>(h) * D,
               q_row, rows, D, vec);
  load_swz<NT, kWgRows, DV>(dos,
               static_cast<const bf16*>(a.dout) +
                   (static_cast<long long>(b) * a.Sq + q0) * o_row +
                   static_cast<long long>(h) * Dv,
               o_row, rows, Dv, vec);
  cp_async_commit();

  const auto fetch = [&](int it) {
    if (it < total) {
      const int k0 = k_begin + it * BK;
      const int nk = min(BK, a.Sk - k0);
      const int s = it % kStages;
      load_swz<NT, BK, DP>(ktile(s), kg + k0 * kv_row, kv_row, nk, D, vec);
      load_swz<NT, BK, DV>(vtile(s), vg + k0 * v_row, v_row, nk, Dv, vec);
    }
    cp_async_commit();
  };
  for (int s = 0; s < kStages - 1; ++s) fetch(s);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g;
  const int qr0 = q0 + r0, qr1 = qr0 + 8;   // this lane's queries
  const int wq_lo = q0, wq_hi = q0 + rows - 1;
  const long long stat = (static_cast<long long>(b) * a.H + h) * a.Sq;
  // a row past the last query gets lse = +inf: P = 0 and dS = 0
  const float nl0 = r0 < rows ? -a.lse[stat + qr0] * kLog2e : -INFINITY;
  const float nl1 = r0 + 8 < rows ? -a.lse[stat + qr1] * kLog2e : -INFINITY;
  const float d0 = r0 < rows ? a.delta[stat + qr0] : 0.f;
  const float d1 = r0 + 8 < rows ? a.delta[stat + qr1] : 0.f;
  const float scale_log2 = a.scale * kLog2e;

  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;


  const uint64_t qsd = wg::kdesc(qs), osd = wg::kdesc(dos);
  for (int it = 0; it < total; ++it) {
    cp_async_wait<kStages - 2>();
    wg::fence_async();
    bar_sync(1, NT);   // tile `it` is in, and the group is done with it-1
    fetch(it + kStages - 1);
    const int s = it % kStages;
    const int k0 = k_begin + it * BK;
    // does a row of the group see a key of this tile?
    bool live = rows > 0;
    if (a.causal) live = live && k0 <= wq_hi;
    if (a.window > 0) live = live && k0 + BK - 1 > wq_lo - a.window;
    if (!live) continue;
    const bool masked = (a.causal && k0 + BK - 1 > wq_lo) ||
                        (a.window > 0 && k0 <= wq_hi - a.window) ||
                        k0 + BK > a.Sk;
    const uint64_t ktd = wg::kdesc(ktile(s)), vtd = wg::kdesc(vtile(s));
    const uint64_t kmn = wg::mndesc(ktile(s), BK);

    float sc[BK / 2], dp[BK / 2];
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wg::Mma<BK>::template ss<0>(sc, wg::kstep<kWgRows>(qsd, kk),
                                  wg::kstep<BK>(ktd, kk), kk);
    }
    wg::commit();
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk) {
      wg::Mma<BK>::template ss<0>(dp, wg::kstep<kWgRows>(osd, kk),
                                  wg::kstep<BK>(vtd, kk), kk);
    }
    wg::commit();
    wg::wait<1>();
    wg::pin(sc);
    // P = 2^(S scale log2 e - lse log2 e), a row a query
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      sc[e] = ex2(__fmaf_rn(sc[e], scale_log2, e & 2 ? nl1 : nl0));
    }
    if (masked) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + 8 * n + 2 * t + (e & 1);
          if (!seen(a, e < 2 ? qr0 : qr1, kj)) sc[4 * n + e] = 0.f;
        }
      }
    }
    wg::wait<0>();
    wg::pin(dp);
    uint32_t df[BK / 16][4];
    // dS = P (dP - delta)
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      dp[e] = sc[e] * (dp[e] - (e & 2 ? d1 : d0));
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) a_frag(df[kk], dp, kk);
    // dQ += dS K, K read MN-major
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wg::Mma<DP>::template rs<1>(dq, df[kk], wg::mnstep(kmn, kk), 1);
    }
    wg::commit();
    wg::wait<0>();
    wg::pin(dq);
  }

  store_rows<DP>(static_cast<bf16*>(a.dq) +
                     (static_cast<long long>(b) * a.Sq + q0) * q_row +
                     static_cast<long long>(h) * D,
                 q_row, dq, r0, rows, D, a.scale, t);
}

template <int DP, int DV>
cudaError_t launch_bwd_bf16(const AttnBwdArgs& a, int vec,
                            cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (a.Sk > 0) {
    constexpr size_t smem = kv_smem_bytes<DP, DV>();
    err = allow_smem<dkdv_wg_kernel<DP, DV>>(smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.Hkv, a.B, (a.Sk + kWgRows - 1) / kWgRows);
    dkdv_wg_kernel<DP, DV><<<grid, kv_threads<DP>(), smem, stream>>>(a,
                                                                    vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (a.Sq > 0) {
    constexpr size_t smem = dq_smem_bytes<DP, DV>();
    err = allow_smem<dq_wg_kernel<DP, DV>>(smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.H, a.B, (a.Sq + kWgRows - 1) / kWgRows);
    dq_wg_kernel<DP, DV><<<grid, 128, smem, stream>>>(a, vec);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

cudaError_t launch_flash_attention_bwd_wgmma(const AttnBwdArgs& a, int vec,
                                             cudaStream_t stream) {
  // head dims padded to 64 (the swizzle atom); V at most 128 wide unless
  // the keys are wider than 192
  const int dp = pad64(a.D), dvp = pad64(a.Dv);
  if (dp <= 64) return launch_bwd_bf16<64, 64>(a, vec, stream);
  if (dp <= 128) return launch_bwd_bf16<128, 128>(a, vec, stream);
  if (dvp <= 128) {
    if (dp <= 192) return launch_bwd_bf16<192, 128>(a, vec, stream);
    return launch_bwd_bf16<256, 128>(a, vec, stream);
  }
  return launch_bwd_bf16<256, 256>(a, vec, stream);
}

}  // namespace repro
