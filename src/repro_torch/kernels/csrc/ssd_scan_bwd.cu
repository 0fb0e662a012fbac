// The gradient of the Mamba-2 chunked SSD scan (ssd_scan.cu).
//
// Replaces no TPU kernel: the JAX package trains through XLA's
// differentiation of the plain ops of src/repro/models/ssm.py::ssd_chunked
// (the Pallas kernel src/repro/kernels/ssd_scan.py has no backward).  It
// computes what kernels/ref.py::ssd_bwd_ref computes.  With cum the
// inclusive cumsum of la = -a_h * dt within a chunk of L steps, t and u
// steps of the chunk, W[t][u] = (C_t . B_u) exp(cum_t - cum_u) on the lower
// triangle (u <= t), tail_u = exp(cum_{L-1} - cum_u) and before[c] the state
// before chunk c, which the forward leaves in its scratch with the chunks'
// last cumsums, one call launches four kernels (the wrapper counts them as
// one ssd_scan_bwd launch):
//
// 1. ssd_dstate_kernel, a CTA a (batch, chunk, head): the output's pull on
//    the state before the chunk, G_c = sum_t exp(cum_t) dy_t^T C_t (P x N),
//    to the scratch.
// 2. ssd_bwd_pass_kernel, a CTA a (batch, head, 256 state elements), the
//    forward's state pass run backwards: dbefore[NC] = dstate (or 0),
//      dbefore[c] = exp(cum_{L-1} of c) * dbefore[c + 1] + G_c,
//    dbefore[c + 1] written over G_c (dS of chunk c) and dinit =
//    dbefore[0]; each CTA's part of <dbefore[c + 1], before[c]> (the chunk
//    decay's gradient over its exp) goes to the scratch as one partial a
//    CTA, summed in order by kernel 3: no atomics.
// 3. ssd_scan_bwd_kernel, a CTA a (batch, chunk, group of heads), as the
//    forward's scan_kernel: CB = C B^T once, then for each head, with
//    dS = dbefore[c + 1] and Q[t][u] = dy_t . x_u,
//      D[t][u] = Q[t][u] dt_u exp(cum_t - cum_u)     (the gradient of CB)
//      gx_u = sum_t W[t][u] dy_t + tail_u dS B_u      (of dt_u x_u)
//      dx_u = dt_u gx_u,  ddt_u = x_u . gx_u - a_h dla_u
//      dC_t += sum_u D[t][u] B_u + exp(cum_t) before^T dy_t
//      dB_u += sum_t D[t][u] C_t + tail_u dt_u x_u^T dS
//      d cum_t = sum_u (CB o D)[t][u] - sum_u (CB o D)[u][t]
//                + exp(cum_t) C_t . before^T dy_t - tail_t dt_t x_t . dS B_t
//      d cum_{L-1} += sum_u tail_u dt_u x_u . dS B_u
//                     + exp(cum_{L-1}) <dS, before[c]>
//    and dla the reverse cumsum of d cum within the chunk; da_h's part of
//    the chunk, -sum_u dt_u dla_u, and the CTA's dB and dC summed over its
//    heads go to the scratch.  exp is taken on the lower triangle only, as
//    in the forward.
// 4. ssd_bwd_sum_kernel: dB and dC summed over a chunk's head groups, da
//    over the batch and the chunks, each in a fixed order.
//
// Deterministic: no atomics, every sum in a fixed order, so the same
// inputs give the same bits.  cum is summed in order by one thread, as the
// forward sums it, so both see the same decays.
//
// Bound on the card: operations.  At zamba2-2.7b's training call (B = 4,
// S = 512, 80 heads, P = N = 64, f32) the products a chunk and head needs
// (Q, the dx and dB / dC intra terms, dS B, x^T dS, before^T dy, G) are
// ~2.7 MFLOP at L = 64, ~7 GFLOP a call, 0.04 ms at the split-TF32 rate
// (495 / 3 TFLOP/s), above the ~0.02 ms the inputs, the saved states and
// the outputs take at 3.35 TB/s.  This first design runs its products on
// the CUDA cores in f32 (fmaf, 4 x 4 register tiles a thread out of
// shared memory, ~67 TFLOP/s at best): a simple kernel that is right and
// runs its own source under the host emulation (tests/host_cuda), with
// the tensor cores (mma.cuh's split TF32, as the forward) left to a later
// PR.  Its grid is one wave: a chunk's heads split into as many groups as
// the SMs allow (kernels/ssd_scan.py::bwd_plan mirrors it), each CTA
// computing CB once for its heads.
//
// Shared memory of a chunk-scan CTA (bwd_plan mirrors it): C, B (L x N),
// CB, W, Q / D (L x L), x, dy (L x P), one state (P x N: before[c], then
// dS), one L x max(N, P) product, and ten L vectors, f32, rows padded to 4
// columns plus one (an odd stride: a column read a row a lane hits 32
// banks).  152 KB at L = 64, P = N = 64; 219 KB at L = 64, N = 128.  The
// wrapper picks L (at most 128) so that it fits in 227 KB.
#include <cuda_bf16.h>
#include <stdint.h>

#include <math.h>

#include "dtype.cuh"
#include "kernels.h"
#include "mma.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;        // every kernel's CTA
constexpr int kMaxL = 128;
constexpr int kMaxP = 128;
constexpr int kMaxN = 128;
constexpr int kVectors = 10;         // L-long vectors of the scan CTA
constexpr size_t kMaxSmem = 232448;

__host__ __device__ constexpr int pad4(int n) { return (n + 3) / 4 * 4; }
// the row stride of a tile of `cols` columns: padded to 4, plus one
__host__ __device__ constexpr int stride(int cols) { return pad4(cols) + 1; }

size_t scan_smem_bytes(int L, int P, int N) {
  const size_t lt = pad4(L), pp = pad4(P);
  const size_t sn = stride(N), sp = stride(P), sl = stride(L);
  const size_t su = sn > sp ? sn : sp;
  return sizeof(float) * (2 * lt * sn + 3 * lt * sl + 2 * lt * sp +
                          pp * sn + lt * su + kVectors * lt + 4);
}

size_t state_smem_bytes(int L, int P, int N) {
  const size_t lt = pad4(L);
  return sizeof(float) * (lt * stride(P) + lt * stride(N) + 3 * lt);
}

// Where the scratch's pieces start (floats): the G / dS states (B, NC, H,
// P, N), the pass's dot partials (B, NC, H, X), the dB and dC partials
// (B * NC, groups, L, N) and da's (B, NC, H).  kernels/ssd_scan.py sizes it.
struct Scratch {
  float* gs;
  float* dots;
  float* db;
  float* dc;
  float* da;
};

__host__ __device__ inline int pass_ctas(int P, int N) {
  return (P * N + kThreads - 1) / kThreads;
}

__host__ __device__ inline Scratch scratch_of(const SsdBwdArgs& a, int NC) {
  const long long bnh = static_cast<long long>(a.B) * NC * a.H;
  const long long part = static_cast<long long>(a.B) * NC * a.groups * a.L *
                         a.N;
  Scratch s;
  s.gs = a.scratch;
  s.dots = s.gs + bnh * a.P * a.N;
  s.db = s.dots + bnh * pass_ctas(a.P, a.N);
  s.dc = s.db + part;
  s.da = s.dc + part;
  return s;
}

// Rows [0, n) of a (rows x cols_pad) f32 tile at dst (row stride ds), row
// j from src + j * ss (cols values, converted to f32); rows [n, rows) and
// columns [cols, cols_pad) as zeros.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ds, const T* src,
                                          long long ss, int n, int rows,
                                          int cols, int cols_pad) {
  const int total = rows * cols_pad;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int j = i / cols_pad;
    const int k = i - j * cols_pad;
    dst[j * ds + k] = (j < n && k < cols) ? to_f32(src[j * ss + k]) : 0.f;
  }
}

// cum[u] = the inclusive cumsum of neg_a * dts[u] over u < lt, in order,
// by one thread: the forward's chunk_cumsum (ssd_scan.cu), whose padded
// steps (dt = 0) keep the sum, so cum[lt - 1] is the chunk's last cumsum.
__device__ __forceinline__ void chunk_cumsum(const float* dts, float* cum,
                                             int lt, float neg_a) {
  float run = 0.f;
  for (int u = 0; u < lt; ++u) {
    run += neg_a * dts[u];
    cum[u] = run;
  }
}

// The CTA's 4 x 4 output tiles of an (M x Nn) product, M and Nn multiples
// of 4: tile i takes rows 4 (i / nb) .. + 3 and columns i % nb + jj * nb
// (jj = 0..3, nb = Nn / 4), so adjacent threads take adjacent columns.
// body(i0, jb, nb) computes and stores one tile.
template <typename F>
__device__ __forceinline__ void for_tiles(int M, int Nn, F body) {
  const int nb = Nn >> 2, total = (M >> 2) * nb;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    body((i / nb) * 4, i % nb, nb);
  }
}

// acc[i][jj] += sum over k in [k0, k1) of fa(i0 + i, k) * fb(k, jb + jj * nb)
template <typename FA, typename FB>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], int i0, int jb,
                                         int nb, int k0, int k1, FA fa,
                                         FB fb) {
  for (int k = k0; k < k1; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = fa(i0 + i, k);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = fb(k, jb + j * nb);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// sum over k in [k0, k1) of a[k * sa] * b[k * sb], in order
__device__ __forceinline__ float dot_range(const float* a, int sa,
                                           const float* b, int sb, int k0,
                                           int k1) {
  float sum = 0.f;
  for (int k = k0; k < k1; ++k) sum = fmaf(a[k * sa], b[k * sb], sum);
  return sum;
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
}

// ------------------------------------------- 1. the pull on each state
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_dstate_kernel(SsdBwdArgs a, int NC) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = a.L, P = a.P, N = a.N, H = a.H;
  const int lt = pad4(L), pp = pad4(P), np = pad4(N);
  const int sp = stride(P), sn = stride(N);
  float* dys = reinterpret_cast<float*>(smem);   // lt x sp: dy, (t, p)
  float* cs = dys + lt * sp;                      // lt x sn: C, (t, n)
  float* dts = cs + lt * sn;
  float* cum = dts + lt;
  float* ecum = cum + lt;

  const int bch = blockIdx.x;                     // (b * NC + c) * H + h
  const int h = bch % H, c = (bch / H) % NC, b = bch / (H * NC);
  const int t0 = c * L, rows = min(L, a.S - t0);
  const long long tok0 = static_cast<long long>(b) * a.S + t0;
  load_tile(dys, sp, a.dy + (tok0 * H + h) * P,
            static_cast<long long>(H) * P, rows, lt, P, pp);
  load_tile(cs, sn, static_cast<const T*>(a.c) + tok0 * N, N, rows, lt, N,
            np);
  const T* dt = static_cast<const T*>(a.dt);
  for (int u = threadIdx.x; u < lt; u += kThreads) {
    dts[u] = u < rows ? to_f32(dt[(tok0 + u) * H + h]) : 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0) chunk_cumsum(dts, cum, lt, -a.a[h]);
  __syncthreads();
  for (int t = threadIdx.x; t < lt; t += kThreads) ecum[t] = expf(cum[t]);
  __syncthreads();
  for (int i = threadIdx.x; i < lt * pp; i += kThreads) {
    const int t = i / pp;
    dys[t * sp + i - t * pp] *= ecum[t];
  }
  __syncthreads();

  float* out = scratch_of(a, NC).gs + static_cast<long long>(bch) * P * N;
  for_tiles(pp, np, [&](int i0, int jb, int nb) {
    float acc[4][4];
    zero(acc);
    tile_dot(acc, i0, jb, nb, 0, lt,
             [&](int p, int t) { return dys[t * sp + p]; },
             [&](int t, int n) { return cs[t * sn + n]; });
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = i0 + i, n = jb + j * nb;
        if (p < P && n < N) out[p * N + n] = acc[i][j];
      }
    }
  });
}

// ------------------------------------------ 2. the reverse state pass
// A thread carries one element of one (batch, head)'s state gradient
// through the chunks, last to first.
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_pass_kernel(SsdBwdArgs a, int NC) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sums = reinterpret_cast<float*>(smem);   // 2 x 8 warp sums
  const int X = pass_ctas(a.P, a.N), PN = a.P * a.N;
  const int xb = blockIdx.x % X, h = (blockIdx.x / X) % a.H;
  const int b = blockIdx.x / (X * a.H);
  const int e = xb * kThreads + threadIdx.x;
  const bool valid = e < PN;
  const long long hb = static_cast<long long>(b) * a.H + h;
  const Scratch s = scratch_of(a, NC);
  const float* before = a.states;
  const float* cum_last =
      a.states + static_cast<long long>(a.B) * NC * a.H * PN;
  float carry = (valid && a.dstate) ? a.dstate[hb * PN + e] : 0.f;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = NC - 1; c >= 0; --c) {
    const long long bc = (static_cast<long long>(b) * NC + c) * a.H + h;
    float g = 0.f, part = 0.f;
    if (valid) {
      g = s.gs[bc * PN + e];
      part = carry * before[bc * PN + e];
      s.gs[bc * PN + e] = carry;              // dS of chunk c
    }
    for (int off = 16; off > 0; off >>= 1) {
      part += __shfl_xor_sync(0xffffffffu, part, off);
    }
    float* slot = sums + (c & 1) * 8;
    if (lane == 0) slot[warp] = part;
    // one barrier a chunk: a slot is written again two chunks later,
    // after thread 0 has passed the next barrier, so it has read it
    __syncthreads();
    if (threadIdx.x == 0) {
      float total = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) total += slot[w];
      s.dots[bc * X + xb] = total;
    }
    carry = carry * expf(cum_last[bc]) + g;
  }
  if (valid && a.dinit) a.dinit[hb * PN + e] = carry;
}

// ------------------------------------------ 3. the chunks' gradients
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_bwd_kernel(SsdBwdArgs a, int NC) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = a.L, P = a.P, N = a.N, H = a.H, G = a.groups;
  const int lt = pad4(L), pp = pad4(P), np = pad4(N);
  const int sn = stride(N), sp = stride(P), sl = stride(L);
  const int su = sn > sp ? sn : sp;
  float* cs = reinterpret_cast<float*>(smem);   // lt x sn: C, (t, n)
  float* bs = cs + lt * sn;                      // lt x sn: B, (u, n)
  float* cb = bs + lt * sn;                      // lt x sl: C B^T, (t, u)
  float* wt = cb + lt * sl;                      // lt x sl: W, (t, u)
  float* dm = wt + lt * sl;                      // lt x sl: Q, then D
  float* xs = dm + lt * sl;                      // lt x sp: x, (u, p)
  float* dys = xs + lt * sp;                     // lt x sp: dy, (t, p)
  float* st = dys + lt * sp;                     // pp x sn: before, then dS
  float* pr = st + pp * sn;                      // lt x su: Z, then dS B, gx
  float* dts = pr + lt * su;
  float* cum = dts + lt;
  float* ecum = cum + lt;
  float* tail = ecum + lt;
  float* rowr = tail + lt;     // sum_u (CB o D)[t][u]
  float* colr = rowr + lt;     // sum_t (CB o D)[t][u]
  float* zc = colr + lt;       // exp(cum_t) C_t . before^T dy_t
  float* rr = zc + lt;         // x_u . dS B_u
  float* gdt = rr + lt;        // x_u . gx_u
  float* dcum = gdt + lt;
  float* dot = dcum + lt;      // <dS, before[c]>

  const int q = blockIdx.x / G, g = blockIdx.x - q * G;
  const int b = q / NC, c = q - b * NC;
  const int h_lo = g * H / G, h_hi = (g + 1) * H / G;
  const int t0 = c * L, rows = min(L, a.S - t0);
  const long long tok0 = static_cast<long long>(b) * a.S + t0;
  const int PN = P * N, X = pass_ctas(P, N);
  const Scratch s = scratch_of(a, NC);
  const T* x = static_cast<const T*>(a.x);
  const T* dt = static_cast<const T*>(a.dt);
  // this CTA's dB / dC partials, (L, N), summed over its heads
  float* pdb = s.db + static_cast<long long>(blockIdx.x) * L * N;
  float* pdc = s.dc + static_cast<long long>(blockIdx.x) * L * N;

  load_tile(cs, sn, static_cast<const T*>(a.c) + tok0 * N, N, rows, lt, N,
            np);
  load_tile(bs, sn, static_cast<const T*>(a.b) + tok0 * N, N, rows, lt, N,
            np);
  __syncthreads();
  for_tiles(lt, lt, [&](int i0, int jb, int nb) {
    float acc[4][4];
    zero(acc);
    tile_dot(acc, i0, jb, nb, 0, np,
             [&](int t, int n) { return cs[t * sn + n]; },
             [&](int n, int u) { return bs[u * sn + n]; });
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) cb[(i0 + i) * sl + jb + j * nb] = acc[i][j];
    }
  });

  for (int h = h_lo; h < h_hi; ++h) {
    const bool first = h == h_lo;
    const long long bch = (static_cast<long long>(b) * NC + c) * H + h;
    load_tile(xs, sp, x + (tok0 * H + h) * P, static_cast<long long>(H) * P,
              rows, lt, P, pp);
    load_tile(dys, sp, a.dy + (tok0 * H + h) * P,
              static_cast<long long>(H) * P, rows, lt, P, pp);
    load_tile(st, sn, a.states + bch * PN, N, P, pp, N, np);
    for (int u = threadIdx.x; u < lt; u += kThreads) {
      dts[u] = u < rows ? to_f32(dt[(tok0 + u) * H + h]) : 0.f;
    }
    __syncthreads();   // also: CB written
    if (threadIdx.x == 0) chunk_cumsum(dts, cum, lt, -a.a[h]);
    __syncthreads();
    for (int t = threadIdx.x; t < lt; t += kThreads) {
      ecum[t] = expf(cum[t]);
      tail[t] = expf(cum[lt - 1] - cum[t]);
    }
    // Q = dy x^T on the lower triangle; Z = dy before (t, n)
    for_tiles(lt, lt, [&](int i0, int jb, int nb) {
      float acc[4][4];
      zero(acc);
      tile_dot(acc, i0, jb, nb, 0, pp,
               [&](int t, int p) { return dys[t * sp + p]; },
               [&](int p, int u) { return xs[u * sp + p]; });
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = i0 + i, u = jb + j * nb;
          dm[t * sl + u] = u <= t ? acc[i][j] : 0.f;
        }
      }
    });
    for_tiles(lt, np, [&](int i0, int jb, int nb) {
      float acc[4][4];
      zero(acc);
      tile_dot(acc, i0, jb, nb, 0, pp,
               [&](int t, int p) { return dys[t * sp + p]; },
               [&](int p, int n) { return st[p * sn + n]; });
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pr[(i0 + i) * su + jb + j * nb] = acc[i][j];
        }
      }
    });
    __syncthreads();
    // W = CB exp(cum_t - cum_u) and D = Q dt_u exp(cum_t - cum_u) on the
    // lower triangle; the inter term of d cum
    for (int i = threadIdx.x; i < lt * lt; i += kThreads) {
      const int t = i / lt, u = i - t * lt;
      float w = 0.f;
      if (u <= t) {
        const float e = expf(cum[t] - cum[u]);
        w = cb[t * sl + u] * e;
        dm[t * sl + u] = dm[t * sl + u] * dts[u] * e;
      }
      wt[t * sl + u] = w;
    }
    for (int t = threadIdx.x; t < lt; t += kThreads) {
      float sum = 0.f;
      zc[t] = ecum[t] * dot_range(cs + t * sn, 1, pr + t * su, 1, 0, np);
    }
    __syncthreads();
    // dC = D B + exp(cum_t) Z, into the CTA's partial; CB o D's row and
    // column sums
    for_tiles(lt, np, [&](int i0, int jb, int nb) {
      float acc[4][4];
      zero(acc);
      tile_dot(acc, i0, jb, nb, 0, min(i0 + 4, lt),
               [&](int t, int u) { return dm[t * sl + u]; },
               [&](int u, int n) { return bs[u * sn + n]; });
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = i0 + i, n = jb + j * nb;
          if (t < L && n < N) {
            const float v = acc[i][j] + ecum[t] * pr[t * su + n];
            pdc[t * N + n] = first ? v : pdc[t * N + n] + v;
          }
        }
      }
    });
    if (threadIdx.x < lt) {
      const int t = threadIdx.x;
      rowr[t] = dot_range(cb + t * sl, 1, dm + t * sl, 1, 0, t + 1);
    } else if (threadIdx.x < 2 * lt) {
      const int u = threadIdx.x - lt;
      colr[u] = dot_range(cb + u, sl, dm + u, sl, u, lt);
    }
    __syncthreads();   // Z and before read
    load_tile(st, sn, s.gs + bch * PN, N, P, pp, N, np);
    if (threadIdx.x == 0) {
      float sum = 0.f;
      for (int i = 0; i < X; ++i) sum += s.dots[bch * X + i];
      dot[0] = sum;
    }
    __syncthreads();
    // dS B_u (u, p); dB = D^T C + tail_u dt_u x^T dS, into the CTA's
    // partial
    for_tiles(lt, pp, [&](int i0, int jb, int nb) {
      float acc[4][4];
      zero(acc);
      tile_dot(acc, i0, jb, nb, 0, np,
               [&](int u, int n) { return bs[u * sn + n]; },
               [&](int n, int p) { return st[p * sn + n]; });
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pr[(i0 + i) * su + jb + j * nb] = acc[i][j];
        }
      }
    });
    for_tiles(lt, np, [&](int i0, int jb, int nb) {
      float acc[4][4], acc2[4][4];
      zero(acc);
      zero(acc2);
      tile_dot(acc, i0, jb, nb, i0, lt,
               [&](int u, int t) { return dm[t * sl + u]; },
               [&](int t, int n) { return cs[t * sn + n]; });
      tile_dot(acc2, i0, jb, nb, 0, pp,
               [&](int u, int p) { return xs[u * sp + p]; },
               [&](int p, int n) { return st[p * sn + n]; });
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int u = i0 + i;
        const float scale = tail[u] * dts[u];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = jb + j * nb;
          if (u < L && n < N) {
            const float v = acc[i][j] + scale * acc2[i][j];
            pdb[u * N + n] = first ? v : pdb[u * N + n] + v;
          }
        }
      }
    });
    __syncthreads();
    for (int u = threadIdx.x; u < lt; u += kThreads) {
      rr[u] = dot_range(xs + u * sp, 1, pr + u * su, 1, 0, pp);
    }
    __syncthreads();
    // gx = W^T dy + tail_u dS B_u, over dS B in place (a tile's owner
    // reads and writes it)
    for_tiles(lt, pp, [&](int i0, int jb, int nb) {
      float acc[4][4];
      zero(acc);
      tile_dot(acc, i0, jb, nb, i0, lt,
               [&](int u, int t) { return wt[t * sl + u]; },
               [&](int t, int p) { return dys[t * sp + p]; });
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int u = i0 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* o = pr + u * su + jb + j * nb;
          *o = acc[i][j] + tail[u] * *o;
        }
      }
    });
    __syncthreads();
    // dx = dt_u gx_u; the direct ddt_u = x_u . gx_u
    T* dx = static_cast<T*>(a.dx);
    for (int i = threadIdx.x; i < rows * P; i += kThreads) {
      const int u = i / P, p = i - u * P;
      dx[(tok0 + u) * H * P + static_cast<long long>(h) * P + p] =
          from_f32<T>(dts[u] * pr[u * su + p]);
    }
    for (int u = threadIdx.x; u < lt; u += kThreads) {
      gdt[u] = dot_range(xs + u * sp, 1, pr + u * su, 1, 0, pp);
    }
    __syncthreads();
    // d cum, its reverse cumsum dla, ddt and da's part, in order
    if (threadIdx.x == 0) {
      const float neg_a = -a.a[h];
      float tails = 0.f;
      for (int t = 0; t < lt; ++t) {
        const float tt = tail[t] * dts[t] * rr[t];
        tails += tt;
        dcum[t] = rowr[t] - colr[t] + zc[t] - tt;
      }
      dcum[lt - 1] += tails + expf(cum[lt - 1]) * dot[0];
      T* ddt = static_cast<T*>(a.ddt);
      float run = 0.f, da = 0.f;
      for (int t = lt - 1; t >= 0; --t) {
        run += dcum[t];
        if (t < rows) {
          ddt[(tok0 + t) * H + h] = from_f32<T>(gdt[t] + neg_a * run);
        }
        da = fmaf(dts[t], run, da);
      }
      s.da[bch] = -da;
    }
    __syncthreads();   // the next head's tiles overwrite what it read
  }
}

// ------------------------------------------------- 4. the fixed-order sums
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_sum_kernel(SsdBwdArgs a, int NC) {
  const Scratch s = scratch_of(a, NC);
  const long long bsn = static_cast<long long>(a.B) * a.S * a.N;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i < 2 * bsn) {
    const bool is_c = i >= bsn;
    const long long e = is_c ? i - bsn : i;
    const int n = static_cast<int>(e % a.N);
    const long long tok = e / a.N;
    const int b = static_cast<int>(tok / a.S);
    const int pos = static_cast<int>(tok - static_cast<long long>(b) * a.S);
    const int c = pos / a.L, t = pos - c * a.L;
    const float* part = (is_c ? s.dc : s.db) +
                        ((static_cast<long long>(b) * NC + c) * a.groups *
                             a.L + t) * a.N + n;
    const long long step = static_cast<long long>(a.L) * a.N;
    float sum = 0.f;
    for (int g = 0; g < a.groups; ++g) sum += part[g * step];
    static_cast<T*>(is_c ? a.dc : a.db)[e] = from_f32<T>(sum);
  } else if (i < 2 * bsn + a.H) {
    const int h = static_cast<int>(i - 2 * bsn);
    float sum = 0.f;
    for (long long bc = 0; bc < static_cast<long long>(a.B) * NC; ++bc) {
      sum += s.da[bc * a.H + h];
    }
    a.da[h] = sum;
  }
}

// --------------------------------------------------------------- launch
template <typename... Exp, typename... Act>
cudaError_t launch(void (*kernel)(Exp...), long long ctas, size_t smem,
                   cudaStream_t stream, Act... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ctas));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = nullptr;
  cfg.numAttrs = 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const SsdBwdArgs& a, cudaStream_t stream) {
  const int NC = (a.S + a.L - 1) / a.L;
  const long long bnh = static_cast<long long>(a.B) * NC * a.H;
  size_t smem = state_smem_bytes(a.L, a.P, a.N);
  cudaError_t err = allow_smem<ssd_dstate_kernel<T>>(smem);
  if (err != cudaSuccess) return err;
  err = launch(ssd_dstate_kernel<T>, bnh, smem, stream, a, NC);
  if (err != cudaSuccess) return err;
  err = launch(ssd_bwd_pass_kernel, static_cast<long long>(a.B) * a.H *
                                pass_ctas(a.P, a.N),
               16 * sizeof(float), stream, a, NC);
  if (err != cudaSuccess) return err;
  smem = scan_smem_bytes(a.L, a.P, a.N);
  err = allow_smem<ssd_scan_bwd_kernel<T>>(smem);
  if (err != cudaSuccess) return err;
  err = launch(ssd_scan_bwd_kernel<T>,
               static_cast<long long>(a.B) * NC * a.groups, smem, stream, a,
               NC);
  if (err != cudaSuccess) return err;
  const long long sums = 2LL * a.B * a.S * a.N + a.H;
  return launch(ssd_bwd_sum_kernel<T>, (sums + kThreads - 1) / kThreads, 0,
                stream, a, NC);
}

}  // namespace

cudaError_t launch_ssd_scan_bwd(const SsdBwdArgs& a, int dtype,
                                cudaStream_t stream) {
  if (a.L <= 0 || a.L > kMaxL || a.P <= 0 || a.P > kMaxP || a.N <= 0 ||
      a.N > kMaxN || a.B <= 0 || a.H <= 0 || a.S <= 0 || a.groups <= 0 ||
      a.groups > a.H || a.scratch == nullptr || a.states == nullptr ||
      scan_smem_bytes(a.L, a.P, a.N) > kMaxSmem) {
    return cudaErrorInvalidValue;
  }
  if (dtype == kBF16) return launch_typed<__nv_bfloat16>(a, stream);
  if (dtype != kF32) return cudaErrorInvalidValue;
  return launch_typed<float>(a, stream);
}

}  // namespace repro
