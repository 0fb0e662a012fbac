// Mamba-2 chunked SSD scan (state-space duality, arXiv:2405.21060), with its
// products on the tensor cores.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan.py::_ssd_kernel,
// whose sequential grid walks the chunks of one (batch, head) and carries
// the (P x N) state in VMEM scratch.  Here the chunks run in parallel, as in
// Mamba-2's own GPU kernels (chunk state, state passing, chunk scan).  With
// cum the inclusive cumsum of la = -a_h * dt over a chunk of L steps and u,
// t steps of the chunk, one call launches three kernels (the wrapper counts
// them as one ssd_scan launch):
//
// 1. state_kernel, grid (H, NC, B), 8 warps: the chunk's own end state
//      S_c = (x * tail * dt)^T B,   tail_u = exp(cum_{L-1} - cum_u)
//    (P x N, a product over the L steps), written to an f32 scratch of
//    shape (B, NC, H, P, N), and cum_{L-1} to (B, NC, H).
// 2. pass_kernel, grid (P * N / 1024, H, B): the state before each chunk,
//      before[0] = initial_state (or 0);
//      before[c + 1] = exp(cum_{L-1} of c) * before[c] + S_c,
//    elementwise over P x N, written over S_c; the last carry is the
//    returned state.
// 3. scan_kernel, 16 warps: the chunk's output, the intra-chunk part of
//    phase 1 fused with phase 3 around the state pass.  A CTA computes
//      CB = C B^T (L x L; it does not depend on the head)
//    once, then for each head it serves
//      y_t = exp(cum_t) * C_t . before[c]^T
//            + sum_{u <= t} CB[t][u] * exp(cum_t - cum_u) * dt_u * x_u,
//    written once to y.  exp is taken on the lower triangle only: above it
//    cum_t - cum_u > 0 and would overflow (the Pallas kernel masks it the
//    same way).  A CTA takes 169 KB of shared memory, one an SM, so the
//    grid is one wave: the wrapper's scan_ctas CTAs (132 at the serve
//    shape) are spread over the B * NC chunks and a chunk's CTAs split its
//    heads (4 or 5 each at the serve shape), which computes CB once per 4
//    or 5 heads.  Warps w, w + 4, w + 8 and w + 12 share an SM
//    sub-partition; they take the 16-row tiles w and 7 - w, so the
//    triangle's work is even, and half of the columns of p each.
//
// Tiles are staged in shared memory as f32 (bf16 inputs are widened,
// exactly).  Every product runs as mma.sync m16n8k8 in split TF32
// (mma.cuh), which keeps f32 accuracy; an operand that is a bf16 input is
// exact in TF32, so its lo terms are left out, and CB of bf16 inputs runs
// as m16n8k16 bf16 with f32 accumulators (both operands exact).  As in
// flash_attention.cu the k index is remapped so that every fragment is a
// 16-byte or a conflict-free shared-memory load: for C, B and the state
// (k over N) lane t reads columns 4t..4t+3 of each 16, rows 16 words apart
// mod 32; for x and the decayed CB (k over the steps u) k = t and t + 4
// map to steps 2t and 2t + 1, the columns a lane holds in an accumulator.
// P and N are padded to 16 with zeros in shared memory; P <= 128.  cum is
// summed in order by one thread, the plain version's order, so the decays
// round as its do.
//
// A ragged last chunk is read as zeros past S: its steps have dt = 0, so
// decay 1 and no input, and the state after it is the state at step S.
//
// Shared memory (kernels/ssd_scan.py::smem_bytes mirrors it) at L = 128,
// P = N = 64: 169 KB for a chunk-scan CTA (CB, C, B or x, the state), 69 KB
// for a chunk-state CTA.  The wrapper picks a shorter L when a CTA would
// not fit in 227 KB (mamba2-1.3b's N = 128 takes L = 64); the scan's
// result does not depend on L.  The opt-in above 48 KB is made once per
// kernel and device.
//
// Bound on the card at the serving path's prefill (B = 1, S = 996, 80 heads,
// P = N = 64, f32): bytes.  x, dt, B, C read once and y, the state written
// once are ~42.9 MB, 0.0128 ms at 3.35 TB/s; the least work (CB once per
// chunk) is 1.96 GFLOP, 0.0119 ms at the split-TF32 rate (495 / 3
// TFLOP/s).  This design moves more (x is read by kernels 1 and 3, the
// chunk states, 10.5 MB, cross the scratch three times, mostly in L2) and
// does more (CB once per CTA, the triangle in whole 8-step tiles); its
// mma.sync TF32 products run far below the TF32 rate (PERF.md).
#include <cuda_bf16.h>
#include <stdint.h>

#include <math.h>

#include <type_traits>

#include "dtype.cuh"
#include "kernels.h"
#include "mma.cuh"

namespace repro {
namespace {

constexpr int kScanThreads = 512;    // 16 warps, two on each 16-row tile
constexpr int kStateThreads = 256;   // 8 warps
constexpr int kPassThreads = 256;
constexpr int kMaxL = 128;           // 8 tiles of 16 rows
constexpr int kMaxP = 128;

__host__ __device__ constexpr int pad16(int n) { return (n + 15) / 16 * 16; }

// Row stride (floats) of tiles whose rows a lane reads 16 bytes at a time
// at column 4t: 16 words mod 32 puts the 8 lanes of a phase on 32 banks.
__host__ __device__ constexpr int frag_stride(int np) {
  return np % 32 == 0 ? np + 16 : np;
}
// Row stride of tiles read a column a lane, rows 2t and 2t + 1: 4 mod 8.
__host__ __device__ constexpr int col_stride(int n16) { return n16 + 4; }

size_t scan_smem_bytes(int L, int P, int N) {
  const size_t lt = pad16(L), pp = pad16(P), np = pad16(N);
  const size_t fs = frag_stride(np), xs = col_stride(pp);
  const size_t bx = lt * fs > lt * xs ? lt * fs : lt * xs;
  return sizeof(float) * (lt * (lt + 8) + lt * fs + bx + pp * fs + 2 * lt);
}

size_t state_smem_bytes(int L, int P, int N) {
  const size_t lt = pad16(L), pp = pad16(P), np = pad16(N);
  return sizeof(float) * (lt * col_stride(pp) + lt * col_stride(np) + 3 * lt);
}

// ------------------------------------------------------------ primitives
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Rows [0, n) of a (rows x cols_pad) f32 tile at dst (row stride ds), row j
// from src + j * ss (cols values); rows [n, rows) and columns
// [cols, cols_pad) as zeros.  `vec`: cols, ss and src allow 4-element
// loads.  A thread loads kBatch pieces into registers before it stores any,
// so their loads are in flight together (a store to shared memory through
// a generic pointer would otherwise wait for each load in turn).
template <int kThreads, typename T>
__device__ __forceinline__ void load_tile(float* dst, int ds, const T* src,
                                          long long ss, int n, int rows,
                                          int cols, int cols_pad, bool vec) {
  constexpr int kBatch = 8;
  if (vec) {
    const int per = cols_pad >> 2;
    const int total = rows * per;
    for (int i0 = threadIdx.x; i0 < total; i0 += kThreads * kBatch) {
      float4 v[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int i = i0 + q * kThreads;
        const int j = i / per;
        const int k = (i - j * per) << 2;
        v[q] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < total && j < n && k < cols) v[q] = load4(src + j * ss + k);
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int i = i0 + q * kThreads;
        const int j = i / per;
        const int k = (i - j * per) << 2;
        if (i < total) *reinterpret_cast<float4*>(dst + j * ds + k) = v[q];
      }
    }
  } else {
    const int total = rows * cols_pad;
    for (int i0 = threadIdx.x; i0 < total; i0 += kThreads * kBatch) {
      float v[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int i = i0 + q * kThreads;
        const int j = i / cols_pad;
        const int k = i - j * cols_pad;
        v[q] = (i < total && j < n && k < cols) ? to_f32(src[j * ss + k])
                                                : 0.f;
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int i = i0 + q * kThreads;
        const int j = i / cols_pad;
        if (i < total) dst[j * ds + i - j * cols_pad] = v[q];
      }
    }
  }
}

// cum[u] = the inclusive cumsum of neg_a * dts[u] over u < lt, in order,
// by one thread: the plain version's order, so the decays exp(cum_t - cum_u)
// round as its do (a tree order moves cum by ~1e-5 at |cum| ~ 60, and y by
// ~1e-5 of its size).  The scan kernel hides it behind the C . before^T
// product of the other warps.
__device__ __forceinline__ void chunk_cumsum(const float* dts, float* cum,
                                             int lt, float neg_a) {
  float run = 0.f;
  for (int u0 = 0; u0 < lt; u0 += 16) {   // lt is a multiple of 16
    float v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = dts[u0 + j];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      run += neg_a * v[j];
      cum[u0 + j] = run;
    }
  }
}

// An A fragment of four f32 values as TF32 (hi, lo); an exact operand (a
// bf16 input) is its own hi and has no lo.
template <bool kExact>
__device__ __forceinline__ void split_frag(float v0, float v1, float v2,
                                           float v3, uint32_t* hi,
                                           uint32_t* lo) {
  if constexpr (kExact) {
    hi[0] = __float_as_uint(v0);
    hi[1] = __float_as_uint(v1);
    hi[2] = __float_as_uint(v2);
    hi[3] = __float_as_uint(v3);
  } else {
    split_tf32(v0, hi[0], lo[0]);
    split_tf32(v1, hi[1], lo[1]);
    split_tf32(v2, hi[2], lo[2]);
    split_tf32(v3, hi[3], lo[3]);
  }
}

// c += A B, A as TF32 (hi, lo) and B as the two f32 values of a lane's
// fragment; the lo terms of an exact operand are left out.
template <bool kExactA, bool kExactB>
__device__ __forceinline__ void mma_f32(float* c, const uint32_t* ah,
                                        const uint32_t* al, float b0,
                                        float b1) {
  if constexpr (kExactB) {
    const uint32_t h0 = __float_as_uint(b0), h1 = __float_as_uint(b1);
    if constexpr (!kExactA) mma_tf32(c, al, h0, h1);
    mma_tf32(c, ah, h0, h1);
  } else {
    uint32_t bh0, bl0, bh1, bl1;
    split_tf32(b0, bh0, bl0);
    split_tf32(b1, bh1, bl1);
    if constexpr (kExactA) {
      mma_tf32(c, ah, bl0, bl1);
      mma_tf32(c, ah, bh0, bh1);
    } else {
      mma_split(c, ah, al, bh0, bh1, bl0, bl1);
    }
  }
}

// ------------------------------------------------ 1. the chunks' states
template <typename T>
__global__ void __launch_bounds__(kStateThreads)
    state_kernel(SsdArgs a, bool vec) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) float smem[];
  const int L = a.L, lt = pad16(L), P = a.P, N = a.N;
  const int pp = pad16(P), np = pad16(N);
  const int xs = col_stride(pp), bs = col_stride(np);
  float* xt = smem;            // lt x xs: x of the chunk, (u, p)
  float* bt = xt + lt * xs;    // lt x bs: B of the chunk, (u, n)
  float* dts = bt + lt * bs;   // lt
  float* cum = dts + lt;       // lt
  float* wt = cum + lt;        // lt: exp(cum_{L-1} - cum_u) * dt_u

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int H = a.H, NC = gridDim.y;
  const int t0 = c * L;
  const int rows = min(L, a.S - t0);
  const long long tok0 = static_cast<long long>(b) * a.S + t0;
  const T* x = static_cast<const T*>(a.x);
  const T* dt = static_cast<const T*>(a.dt);
  const T* bm = static_cast<const T*>(a.b);

  load_tile<kStateThreads>(xt, xs, x + (tok0 * H + h) * P,
                           static_cast<long long>(H) * P, rows, lt, P, pp,
                           vec);
  load_tile<kStateThreads>(bt, bs, bm + tok0 * N, N, rows, lt, N, np, vec);
  for (int u = threadIdx.x; u < lt; u += kStateThreads) {
    dts[u] = u < rows ? to_f32(dt[(tok0 + u) * H + h]) : 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0) chunk_cumsum(dts, cum, lt, -a.a[h]);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float last = cum[lt - 1];   // padded steps keep the cumsum
  for (int u = threadIdx.x; u < lt; u += kStateThreads) {
    wt[u] = expf(last - cum[u]) * dts[u];
  }
  const long long bch = (static_cast<long long>(b) * NC + c) * H + h;
  if (threadIdx.x == 0) {
    a.scratch[static_cast<long long>(a.B) * NC * H * P * N + bch] = last;
  }
  __syncthreads();

  // S_c (P x N) = sum over u of (x_u * w_u)^T B_u: a warp takes 16 rows of
  // p by 32 columns of n at a time; k = t, t + 4 <-> steps u0 + 2t, + 1
  const int g = lane >> 2, t = lane & 3;
  const int m_tiles = pp / 16, n_blocks = (np + 31) / 32;
  float* out = a.scratch + bch * P * N;
  for (int item = warp; item < m_tiles * n_blocks;
       item += kStateThreads / 32) {
    const int m0 = (item % m_tiles) * 16;
    const int n0 = (item / m_tiles) * 32;
    float acc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    }
    for (int u0 = 0; u0 < lt; u0 += 8) {
      const int u = u0 + 2 * t;
      const float w0 = wt[u], w1 = wt[u + 1];
      const float* x0 = xt + u * xs + m0 + g;
      uint32_t ah[4], al[4];
      split_frag<false>(x0[0] * w0, x0[8] * w0, x0[xs] * w1, x0[xs + 8] * w1,
                        ah, al);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        if (n0 + n * 8 < np) {
          const float* b0 = bt + u * bs + n0 + n * 8 + g;
          mma_f32<false, kBf16>(acc[n], ah, al, b0[0], b0[bs]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + n * 8 + 2 * t + e;
        const int p0 = m0 + g;
        if (col < N) {
          if (p0 < P) out[p0 * N + col] = acc[n][e];
          if (p0 + 8 < P) out[(p0 + 8) * N + col] = acc[n][2 + e];
        }
      }
    }
  }
}

// ------------------------------------------------ 2. the state pass
// V consecutive floats of the state (4: one 16-byte access)
template <int V>
struct Piece {
  float v[V];
};
template <int V>
__device__ __forceinline__ Piece<V> load_piece(const float* p) {
  Piece<V> r;
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    r.v[0] = q.x;
    r.v[1] = q.y;
    r.v[2] = q.z;
    r.v[3] = q.w;
  } else {
    r.v[0] = *p;
  }
  return r;
}
template <int V>
__device__ __forceinline__ void store_piece(float* p, const Piece<V>& r) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
  } else {
    *p = r.v[0];
  }
}

// A thread carries V elements of one (batch, head)'s state through the
// chunks; 8 chunks' states are loaded before any is overwritten, so their
// loads are in flight together.
template <int V>
__global__ void __launch_bounds__(kPassThreads)
    pass_kernel(SsdArgs a, int NC) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int PN = a.P * a.N;
  const int e = (blockIdx.x * kPassThreads + threadIdx.x) * V;
  if (e >= PN) return;
  const long long hb = static_cast<long long>(b) * a.H + h;
  Piece<V> carry;
  if (a.init) {
    carry = load_piece<V>(a.init + hb * PN + e);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) carry.v[i] = 0.f;
  }
  float* st = a.scratch;
  const float* cum_last =
      a.scratch + static_cast<long long>(a.B) * NC * a.H * PN;
  for (int c0 = 0; c0 < NC; c0 += 8) {
    Piece<V> s[8];
    float d[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      d[j] = 0.f;
      if (c0 + j < NC) {
        const long long bc =
            (static_cast<long long>(b) * NC + c0 + j) * a.H + h;
        s[j] = load_piece<V>(st + bc * PN + e);
        d[j] = expf(cum_last[bc]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (c0 + j < NC) {
        const long long bc =
            (static_cast<long long>(b) * NC + c0 + j) * a.H + h;
        store_piece<V>(st + bc * PN + e, carry);
#pragma unroll
        for (int i = 0; i < V; ++i) carry.v[i] = carry.v[i] * d[j] + s[j].v[i];
      }
    }
  }
  store_piece<V>(a.state + hb * PN + e, carry);
}

// ------------------------------------------------ 3. the chunks' outputs
// acc (16 x 8) += C rows (cr, 16 of them) . B rows (br, 8 of them)^T over
// np columns
template <bool kBf16>
__device__ __forceinline__ void cb_tile(float* acc, const float* cr,
                                        const float* br, int fs, int np,
                                        int g, int t) {
  if constexpr (kBf16) {
    // both operands exact in bf16: m16n8k16 with f32 accumulators
    for (int k0 = 0; k0 < np; k0 += 16) {
      const float* ap = cr + g * fs + k0 + 2 * t;
      const float2 a00 = *reinterpret_cast<const float2*>(ap);
      const float2 a10 = *reinterpret_cast<const float2*>(ap + 8 * fs);
      const float2 a01 = *reinterpret_cast<const float2*>(ap + 8);
      const float2 a11 = *reinterpret_cast<const float2*>(ap + 8 * fs + 8);
      const uint32_t af[4] = {pack_f32(a00.x, a00.y), pack_f32(a10.x, a10.y),
                              pack_f32(a01.x, a01.y), pack_f32(a11.x, a11.y)};
      const float* bp = br + g * fs + k0 + 2 * t;
      const float2 b0 = *reinterpret_cast<const float2*>(bp);
      const float2 b1 = *reinterpret_cast<const float2*>(bp + 8);
      mma_bf16(acc, af, pack_f32(b0.x, b0.y), pack_f32(b1.x, b1.y));
    }
  } else {
    for (int k0 = 0; k0 < np; k0 += 16) {
      const float4 q0 = *reinterpret_cast<const float4*>(cr + g * fs + k0 + 4 * t);
      const float4 q1 =
          *reinterpret_cast<const float4*>(cr + (g + 8) * fs + k0 + 4 * t);
      const float4 kv = *reinterpret_cast<const float4*>(br + g * fs + k0 + 4 * t);
      uint32_t ah[2][4], al[2][4];
      split_frag<false>(q0.x, q1.x, q0.y, q1.y, ah[0], al[0]);
      split_frag<false>(q0.z, q1.z, q0.w, q1.w, ah[1], al[1]);
      mma_f32<false, false>(acc, ah[0], al[0], kv.x, kv.y);
      mma_f32<false, false>(acc, ah[1], al[1], kv.z, kv.w);
    }
  }
}

template <typename T, int PB>
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(SsdArgs a, int NC, bool vec) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int NT = PB / 16;       // 8-column tiles of p a warp owns
  extern __shared__ __align__(16) float smem[];
  const int L = a.L, lt = pad16(L), P = a.P, N = a.N;
  const int pp = pad16(P), np = pad16(N);
  const int fs = frag_stride(np), xs = col_stride(pp), cbs = lt + 8;
  float* cb = smem;                 // lt x cbs: C B^T of the chunk, (t, u)
  float* ct = cb + lt * cbs;        // lt x fs: C of the chunk, (t, n)
  float* bx = ct + lt * fs;         // lt x fs: B, (u, n); then lt x xs: x
  float* bf = bx + max(lt * fs, lt * xs);   // pp x fs: before[c], (p, n)
  float* dts = bf + pp * fs;        // lt
  float* cum = dts + lt;            // lt

  // This CTA's (batch, chunk) and heads: the grid's CTAs are spread over
  // the B * NC chunks as evenly as they go, and a chunk's CTAs split its
  // heads as evenly as they go.
  const int H = a.H, Q = a.B * NC, K = gridDim.x;
  const int q = static_cast<int>(static_cast<long long>(blockIdx.x) * Q / K);
  const auto first = [&](int i) {
    return static_cast<int>((static_cast<long long>(i) * K + Q - 1) / Q);
  };
  const int j = blockIdx.x - first(q), n_q = first(q + 1) - first(q);
  const int h_lo = j * H / n_q, h_hi = (j + 1) * H / n_q;
  const int b = q / NC, c = q - b * NC;
  const int t0 = c * L;
  const int rows = min(L, a.S - t0);
  const long long tok0 = static_cast<long long>(b) * a.S + t0;
  const T* x = static_cast<const T*>(a.x);
  const T* dt = static_cast<const T*>(a.dt);

  load_tile<kScanThreads>(ct, fs, static_cast<const T*>(a.c) + tok0 * N, N,
                          rows, lt, N, np, vec);
  load_tile<kScanThreads>(bx, fs, static_cast<const T*>(a.b) + tok0 * N, N,
                          rows, lt, N, np, vec);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // Warps w, w + 4, w + 8 and w + 12 share an SM sub-partition; they take
  // the 16-row tiles w and 7 - w, the first or the second half of p each.
  const int half = warp >> 3, w8 = warp & 7;
  const int mt = w8 < 4 ? w8 : 11 - w8;
  const int r0 = mt * 16;
  const bool active = r0 < lt;
  const int n_u = 2 * mt + 2;       // 8-step tiles up to the diagonal
  const int nb = half * NT;         // this warp's first 8-column tile of p
  if (active) {
    for (int n = half; n < n_u; n += 2) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      cb_tile<kBf16>(acc, ct + r0 * fs, bx + n * 8 * fs, fs, np, g, t);
      float* o = cb + (r0 + g) * cbs + n * 8 + 2 * t;
      *reinterpret_cast<float2*>(o) = make_float2(acc[0], acc[1]);
      *reinterpret_cast<float2*>(o + 8 * cbs) = make_float2(acc[2], acc[3]);
    }
  }
  __syncthreads();   // CB written; B's rows are not read again

  const int tr0 = r0 + g, tr1 = tr0 + 8;   // this lane's rows
  for (int h = h_lo; h < h_hi; ++h) {
    load_tile<kScanThreads>(bx, xs, x + (tok0 * H + h) * P,
                            static_cast<long long>(H) * P, rows, lt, P, pp,
                            vec);
    load_tile<kScanThreads>(
        bf, fs, a.scratch + ((static_cast<long long>(b) * NC + c) * H + h) * P * N,
        N, P, pp, N, np, vec);
    for (int u = threadIdx.x; u < lt; u += kScanThreads) {
      dts[u] = u < rows ? to_f32(dt[(tok0 + u) * H + h]) : 0.f;
    }
    __syncthreads();
    if (threadIdx.x == 0) chunk_cumsum(dts, cum, lt, -a.a[h]);

    float o[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    }
    // y_inter = exp(cum_t) * C_t . before^T: the product over N first,
    // while thread 0 computes cum
    if (active) {
      for (int k0 = 0; k0 < np; k0 += 16) {
        const float4 q0 =
            *reinterpret_cast<const float4*>(ct + tr0 * fs + k0 + 4 * t);
        const float4 q1 =
            *reinterpret_cast<const float4*>(ct + tr1 * fs + k0 + 4 * t);
        uint32_t ah[2][4], al[2][4];
        split_frag<kBf16>(q0.x, q1.x, q0.y, q1.y, ah[0], al[0]);
        split_frag<kBf16>(q0.z, q1.z, q0.w, q1.w, ah[1], al[1]);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if ((nb + n) * 8 < pp) {
            const float4 sv = *reinterpret_cast<const float4*>(
                bf + ((nb + n) * 8 + g) * fs + k0 + 4 * t);
            mma_f32<kBf16, false>(o[n], ah[0], al[0], sv.x, sv.y);
            mma_f32<kBf16, false>(o[n], ah[1], al[1], sv.z, sv.w);
          }
        }
      }
    }
    __syncthreads();   // cum written

    if (active) {
      const float ct0 = cum[tr0], ct1 = cum[tr1];
      const float e0 = expf(ct0), e1 = expf(ct1);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][0] *= e0;
        o[n][1] *= e0;
        o[n][2] *= e1;
        o[n][3] *= e1;
      }
      // y_intra: (CB * exp(cum_t - cum_u) * dt_u, u <= t) . x, with
      // k = t, t + 4 <-> steps u0 + 2t, u0 + 2t + 1
      for (int kk = 0; kk < n_u; ++kk) {
        const int u = kk * 8 + 2 * t;
        const float2 s0 = *reinterpret_cast<const float2*>(cb + tr0 * cbs + u);
        const float2 s1 = *reinterpret_cast<const float2*>(cb + tr1 * cbs + u);
        const float cu0 = cum[u], cu1 = cum[u + 1];
        const float d0 = dts[u], d1 = dts[u + 1];
        const float p00 = u <= tr0 ? s0.x * expf(ct0 - cu0) * d0 : 0.f;
        const float p10 = u <= tr1 ? s1.x * expf(ct1 - cu0) * d0 : 0.f;
        const float p01 = u + 1 <= tr0 ? s0.y * expf(ct0 - cu1) * d1 : 0.f;
        const float p11 = u + 1 <= tr1 ? s1.y * expf(ct1 - cu1) * d1 : 0.f;
        uint32_t ah[4], al[4];
        split_frag<false>(p00, p10, p01, p11, ah, al);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if ((nb + n) * 8 < pp) {
            const float* xb = bx + u * xs + (nb + n) * 8 + g;
            mma_f32<false, kBf16>(o[n], ah, al, xb[0], xb[xs]);
          }
        }
      }
      float* y0 = a.y + ((tok0 + tr0) * H + h) * P;
      float* y1 = y0 + 8LL * H * P;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = (nb + n) * 8 + 2 * t;
        if (P % 2 == 0) {   // 8-byte stores: col and the row base are even
          if (col < P) {
            if (tr0 < rows) {
              *reinterpret_cast<float2*>(y0 + col) = make_float2(o[n][0], o[n][1]);
            }
            if (tr1 < rows) {
              *reinterpret_cast<float2*>(y1 + col) = make_float2(o[n][2], o[n][3]);
            }
          }
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (col + e < P) {
              if (tr0 < rows) y0[col + e] = o[n][e];
              if (tr1 < rows) y1[col + e] = o[n][2 + e];
            }
          }
        }
      }
    }
    __syncthreads();   // the next head's tiles overwrite x, before and cum
  }
}

// --------------------------------------------------------------- launch
template <typename T, int PB>
cudaError_t launch_scan(const SsdArgs& a, int NC, bool vec,
                        cudaStream_t stream) {
  const size_t smem = scan_smem_bytes(a.L, a.P, a.N);
  cudaError_t err = allow_smem<scan_kernel<T, PB>>(smem);
  if (err != cudaSuccess) return err;
  scan_kernel<T, PB><<<a.scan_ctas, kScanThreads, smem, stream>>>(a, NC, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const SsdArgs& a, cudaStream_t stream) {
  const int NC = (a.S + a.L - 1) / a.L;
  const auto aligned = [](const void* p, size_t bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  const size_t piece = 4 * sizeof(T);
  const bool vec = a.P % 4 == 0 && a.N % 4 == 0 && aligned(a.x, piece) &&
                   aligned(a.b, piece) && aligned(a.c, piece) &&
                   aligned(a.scratch, 16);
  // every chunk gets a scan CTA, and every scan CTA a head
  if (NC > 0 && (a.scan_ctas < a.B * NC ||
                 a.scan_ctas > static_cast<long long>(a.B) * NC * a.H)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err;
  if (NC > 0) {
    const size_t smem = state_smem_bytes(a.L, a.P, a.N);
    err = allow_smem<state_kernel<T>>(smem);
    if (err != cudaSuccess) return err;
    state_kernel<T><<<dim3(a.H, NC, a.B), kStateThreads, smem, stream>>>(a,
                                                                         vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int PN = a.P * a.N;
  const bool vec_pass = PN % 4 == 0 && aligned(a.init, 16) &&
                        aligned(a.state, 16) && aligned(a.scratch, 16);
  if (vec_pass) {
    const dim3 grid((PN / 4 + kPassThreads - 1) / kPassThreads, a.H, a.B);
    pass_kernel<4><<<grid, kPassThreads, 0, stream>>>(a, NC);
  } else {
    const dim3 grid((PN + kPassThreads - 1) / kPassThreads, a.H, a.B);
    pass_kernel<1><<<grid, kPassThreads, 0, stream>>>(a, NC);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || NC == 0) return err;
  if (pad16(a.P) <= 64) return launch_scan<T, 64>(a, NC, vec, stream);
  return launch_scan<T, 128>(a, NC, vec, stream);
}

}  // namespace

cudaError_t launch_ssd_scan(const SsdArgs& a, int dtype,
                            cudaStream_t stream) {
  if (a.L <= 0 || a.L > kMaxL || a.P <= 0 || a.P > kMaxP || a.N <= 0 ||
      a.S < 0) {
    return cudaErrorInvalidValue;
  }
  if (a.B <= 0 || a.H <= 0) return cudaSuccess;
  if (a.S > 0 && a.scratch == nullptr) return cudaErrorInvalidValue;
  if (dtype == kBF16) return launch_typed<__nv_bfloat16>(a, stream);
  if (dtype != kF32) return cudaErrorInvalidValue;
  return launch_typed<float>(a, stream);
}

}  // namespace repro
