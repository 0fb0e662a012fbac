// The gradient of the Mamba-2 chunked SSD scan (ssd_scan.cu), with its
// products on the tensor cores.
//
// Replaces no TPU kernel: it is the gradient of the function of the Pallas
// kernel src/repro/kernels/ssd_scan.py:37 (_ssd_kernel), which has no
// backward; the JAX package trains through XLA's differentiation of the
// plain ops of src/repro/models/ssm.py::ssd_chunked.  It computes what
// kernels/ref.py::ssd_bwd_ref computes.  With cum the inclusive cumsum of
// la = -a_h * dt within a chunk of L steps, t and u steps of the chunk,
// W[t][u] = (C_t . B_u) exp(cum_t - cum_u) on the lower triangle (u <= t),
// tail_u = exp(cum_{L-1} - cum_u) and before[c] the state before chunk c,
// which the forward leaves in its scratch with the chunks' last cumsums,
// one call launches three kernels (the wrapper counts them as one
// ssd_scan_bwd launch):
//
// 1. ssd_bwd_state_kernel, a CTA a (batch, head), (P / 16) x (N / 64)
//    warps: the forward's state pass run backwards, each chunk's pull on
//    its state taken with it.  The carry dS (P x N) stays in the warps'
//    accumulator registers while the CTA walks the chunks from last to
//    first: dS of chunk c = carry, written to the scratch, then
//      carry = exp(cum_{L-1} of c) * carry + (exp(cum) dy)^T C
//    (P x N, a split-TF32 product over the chunk's steps, accumulated into
//    the carry); d initial state = the last carry.  The next chunk's dy and
//    C are copied with cp.async while a chunk computes, and the cumsums of
//    16 chunks at a time are summed in order by one lane each.  It beats
//    a pass that only loads ahead after a kernel of the pulls (PERF.md).
// 2. ssd_scan_bwd_kernel, a CTA a (batch, chunk, group of heads), 16
//    warps (4 row tiles of 16 steps x 4 column quarters): CB = C B^T once,
//    then for each head, with dS the state kernel's and Q[t][u] = dy_t . x_u,
//      D[t][u] = Q[t][u] dt_u exp(cum_t - cum_u)     (the gradient of CB)
//      gx_u = sum_t W[t][u] dy_t + tail_u dS B_u      (of dt_u x_u)
//      dx_u = dt_u gx_u,  ddt_u = x_u . gx_u - a_h dla_u
//      dC_t = (sum_h D) B + sum_h exp(cum_t) before^T dy_t
//      dB_u = (sum_h D)^T C + sum_h tail_u dt_u x_u^T dS
//      d cum_t = sum_u (CB o D)[t][u] - sum_u (CB o D)[u][t]
//                + exp(cum_t) C_t . before^T dy_t - tail_t dt_t x_t . dS B_t
//      d cum_{L-1} += sum_u tail_u dt_u x_u . dS B_u
//                     + exp(cum_{L-1}) <dS, before[c]>
//    and dla the reverse cumsum of d cum within the chunk.  D and the
//    heads' inter terms of dB and dC are summed over the CTA's heads in
//    the warps' registers, so the intra terms are two products a CTA, and
//    the CTA writes its dB / dC partial once.  A head's decays
//    exp(cum_t - cum_u) are taken once into shared memory; the sums of its
//    d cum terms come from the accumulators with quad and column shuffles,
//    one partial a warp.  Two of the warps with the fewest products add
//    up the last head's partials (a suffix scan for dla, ddt, da's part)
//    and sum the next head's cumsum in order, after their own products.
//    The next head's x, dy, before and dS are copied with cp.async while a
//    head computes, where shared memory holds two sets of tiles.
// 3. ssd_bwd_sum_kernel: dB and dC summed over a chunk's head groups, da
//    over the batch and the chunks, each in a fixed order.
//
// Deterministic: no atomics, every sum in a fixed order, so the same
// inputs give the same bits.  cum is summed in order by one thread, as the
// forward sums it, so both see the same decays.  A ragged last chunk is
// read as zeros past S (dt = 0: no input, decay 1).
//
// Products: every one runs as mma.sync m16n8k8 in split TF32 (ssd_mma.cuh:
// an f32 operand as hi + lo, three TF32 products, issued a term at a time
// across a warp's tiles); an operand that is a bf16 input (x, B, C) is
// exact in TF32 and drops its lo terms, and C B^T of bf16 inputs runs as
// m16n8k16 bf16.  dy is f32 (the wrapper widens it), so products with dy
// stay split on its side.  A lane's k indices t and t + 4 are the steps
// or columns 2t and 2t + 1 of each 8, so that a row operand is one 8-byte
// load and a column operand two loads from rows 2t and 2t + 1; the row
// strides (in elements) are picked so that the hot loads hit 32 banks: C,
// B and x rows + 8, dy, before, dS, CB and the decays rows + 4 (read by
// column).  Tiles are f32 in shared memory (x in its own type); P and N
// are padded to 16 with zeros.  Both tile kernels are built for the main
// path's padded widths (L = P = 64, N = 64 or 128), so that their strides
// and loop bounds are constants, and for any width.
//
// Bound on the card: bytes, with operations close behind.  At zamba2-2.7b's
// training call (B = 4, S = 512, 80 heads, P = N = 64, L = 64, f32) the
// inputs, the saved states and the outputs are ~177 MB, 0.053 ms at 3.35
// TB/s; the products a chunk and head needs (Q and W^T dy over the
// triangle, G, dS B, x^T dS, before^T dy; C B^T and the head-summed D's
// products a chunk) are ~6.8 GFLOP, 0.041 ms at the split-TF32 rate (495 /
// 3 TFLOP/s).  The design reads every input once but for dS, which the
// state kernel writes and the chunk-scan kernel reads back (~84 MB, partly
// from L2), and runs the triangle in whole 16 x 8 tiles.  It does not reach
// the bound: mma.sync TF32 runs far below the tensor cores' rate, and a
// head's copies add to its products instead of hiding behind them (PERF.md;
// chip_smoke.py --phases env,ssd-variants).
//
// Shared memory (kernels/ssd_scan.py::bwd_smem_bytes and
// bwd_state_smem_bytes mirror it).  Chunk-scan CTA: C, B (L x N), CB and
// the decays (L x L), a set of head tiles x, dy (L x P), before, dS
// (P x N), the warps' partials and the head vectors, f32: 219.1 KB at
// L = 64, P = N = 64 with two sets of head tiles; at N = 128 two sets
// would take 315.1 KB, so the CTA keeps one (214.1 KB) and copies the next
// head's tiles after the barrier that ends a head's products, exposed.  A
// state CTA: two buffers of dy and C (L x P, L x N) and 16 chunks'
// exp(cumsum), 72.1 KB at P = N = 64, 104.1 KB at N = 128.  The wrapper
// picks L (at most 64) so that a chunk-scan CTA fits in 227 KB.
#include <cuda_bf16.h>
#include <stdint.h>

#include <math.h>

#include <type_traits>

#include "dtype.cuh"
#include "kernels.h"
#include "mma.cuh"
#include "ssd_mma.cuh"

namespace repro {
namespace {

constexpr int kMmaWarps = 16;              // 4 row tiles x 4 column quarters
constexpr int kScanThreads = 32 * kMmaWarps;
// the warps with the fewest products (row tiles 0 and 2, column quarter 3)
// also take a head's d cum sums and the next head's cumsum
constexpr int kTailWarp = 12, kCumWarp = 14;
constexpr int kStateMaxThreads = 512;      // (P / 16) x (N / 64) warps
constexpr int kSumThreads = 256;
constexpr int kMaxL = 64;                  // 4 row tiles of 16 steps
constexpr int kMaxP = 128;
constexpr int kMaxN = 128;
constexpr int kCumBatch = 16;              // chunk cumsums a state CTA holds
constexpr size_t kMaxSmem = 232448;

// which tiles may move by cp.async in 16-byte pieces (the launch's flags)
constexpr int kVecX = 1, kVecDy = 2, kVecStates = 4, kVecBC = 8;

__host__ __device__ constexpr int pad16(int n) { return (n + 15) / 16 * 16; }
// a padded width: K where the kernel is built for it, else n's
template <int K>
__device__ __forceinline__ int padded(int n) {
  return K ? K : pad16(n);
}

// The chunk-scan CTA's shared memory, offsets in floats: C, B, CB, the
// head's decays exp(cum_t - cum_u) (0 above the diagonal), the head tile
// sets, the warps' partials (two sets: a head's, the last head's), the
// head vectors (dt, cum, exp(cum), tail; three sets: the last head's, this
// one's, the next one's).
struct ScanSmem {
  int c, b, cb, e, x[2], dy[2], bf[2], ds[2], parts, vecs, total;
};

// a set of partials: (CB o D) row sums + the inter term of d cum, x . dS B
// and x . gx, each (column quarter, step); (CB o D) column sums (row tile,
// step); <dS, before> a warp
__host__ __device__ constexpr int part_floats(int lt) {
  return 16 * lt + kMmaWarps;
}

__host__ __device__ inline ScanSmem scan_smem(int L, int P, int N,
                                              int sets) {
  const int lt = pad16(L), pp = pad16(P), np = pad16(N);
  ScanSmem s;
  int o = 0;
  s.c = o;
  o += lt * (np + 8);
  s.b = o;
  o += lt * (np + 8);
  s.cb = o;
  o += lt * (lt + 4);
  s.e = o;
  o += lt * (lt + 4);
  for (int i = 0; i < 2; ++i) {
    if (i < sets) {
      s.x[i] = o;
      o += lt * (pp + 8);
      s.dy[i] = o;
      o += lt * (pp + 4);
      s.bf[i] = o;
      o += pp * (np + 4);
      s.ds[i] = o;
      o += pp * (np + 4);
    } else {
      s.x[i] = s.x[0];
      s.dy[i] = s.dy[0];
      s.bf[i] = s.bf[0];
      s.ds[i] = s.ds[0];
    }
  }
  s.parts = o;
  o += 2 * part_floats(lt);
  s.vecs = o;
  o += 3 * 4 * lt;
  s.total = o;
  return s;
}

size_t scan_smem_bytes(int L, int P, int N, int sets) {
  return sizeof(float) * scan_smem(L, P, N, sets).total;
}

// two head tile sets where they fit, else one (0: not even one)
int scan_sets(int L, int P, int N) {
  if (scan_smem_bytes(L, P, N, 2) <= kMaxSmem) return 2;
  return scan_smem_bytes(L, P, N, 1) <= kMaxSmem ? 1 : 0;
}

size_t state_smem_bytes(int L, int P, int N) {
  const size_t lt = pad16(L), pp = pad16(P), np = pad16(N);
  return sizeof(float) *
         (2 * lt * (pp + 4 + np + 4) + kCumBatch * (lt + 2));
}

int state_threads(int P, int N) {
  return 32 * (pad16(P) / 16) * ((pad16(N) + 63) / 64);
}

// Where the scratch's pieces start (floats): the dS states (B, NC, H, P,
// N), the dB and dC partials (B * NC, groups, L, N) and da's (B, NC, H).
// kernels/ssd_scan.py::bwd_scratch_floats sizes it.
struct Scratch {
  float* ds;
  float* db;
  float* dc;
  float* da;
};

__host__ __device__ inline Scratch scratch_of(const SsdBwdArgs& a, int NC) {
  const long long bnh = static_cast<long long>(a.B) * NC * a.H;
  const long long part = static_cast<long long>(a.B) * NC * a.groups * a.L *
                         a.N;
  Scratch s;
  s.ds = a.scratch;
  s.db = s.ds + bnh * a.P * a.N;
  s.dc = s.db + part;
  s.da = s.dc + part;
  return s;
}

// Rows [0, n) of a (rows x cols_pad) tile at dst (row stride ds elements),
// row j from src + j * ss (cols values); rows [n, rows) and columns
// [cols, cols_pad) as zeros.  When the tile keeps the source's type and
// `vec` (cols, ss and src allow 16-byte pieces, cols_pad a multiple of a
// piece, ds * sizeof(TS) a multiple of 16), the pieces move by cp.async
// (the caller commits and waits); else by plain loads and stores, widened
// to TS.
template <typename TS, typename T>
__device__ __forceinline__ void stage_tile(TS* dst, int ds, const T* src,
                                           long long ss, int n, int rows,
                                           int cols, int cols_pad,
                                           bool vec) {
  const int nt = blockDim.x;
  if constexpr (std::is_same<TS, T>::value) {
    if (vec) {
      // piece (j, k) steps by nt pieces in row-major order, without a
      // division a piece
      constexpr int E = 16 / sizeof(T);
      const int per = cols_pad / E;
      const int dj = nt / per, dk = nt - dj * per;
      int j = threadIdx.x / per, k = threadIdx.x - j * per;
      while (j < rows) {
        T* d = dst + j * ds + k * E;
        if (j < n && k * E < cols) {
          cp_async16(d, src + j * ss + k * E);
        } else {
          *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
        }
        j += dj;
        k += dk;
        if (k >= per) {
          k -= per;
          ++j;
        }
      }
      return;
    }
  }
  for (int i = threadIdx.x; i < rows * cols_pad; i += nt) {
    const int j = i / cols_pad;
    const int k = i - j * cols_pad;
    const float v = (j < n && k < cols) ? to_f32(src[j * ss + k]) : 0.f;
    dst[j * ds + k] = from_f32<TS>(v);
  }
}

// two consecutive values of a row, as f32
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return make_float2(to_f32(p[0]), to_f32(p[1]));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// v summed over the 4 lanes of an accumulator row (lanes 4g .. 4g + 3)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// cum[u] = the inclusive cumsum of neg_a * dts[u] over u < lt, in order,
// by one thread: the forward's chunk_cumsum (ssd_scan.cu), whose padded
// steps (dt = 0) keep the sum, so cum[lt - 1] is the chunk's last cumsum.
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

// --------------------------------- 1. the reverse state pass with each pull
// Warp w carries rows 16 (w % (P / 16)) .. + 15 of the state gradient and
// 8-column tiles 8 (w / (P / 16)) .. + 7 of N.  kLT, kPP, kNP: the padded
// L, P and N the kernel is built for (0: read from the call), so that the
// main path's strides and loop bounds are constants.
template <typename T, int kLT, int kPP, int kNP>
__global__ void __launch_bounds__(kStateMaxThreads)
    ssd_bwd_state_kernel(SsdBwdArgs a, int NC, int flags) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sm = reinterpret_cast<float*>(smem);
  const int L = a.L, P = a.P, N = a.N, H = a.H;
  const int lt = padded<kLT>(L), pp = padded<kPP>(P), np = padded<kNP>(N);
  const int sdy = pp + 4;                     // dy: (t, p), read by column
  const int sc = np + 16 / sizeof(T);         // C: (t, n), read by column
  const int buf_floats = lt * (pp + 4 + np + 4);
  const int se = lt + 1;                      // odd: a row a lane
  float* ec = sm + 2 * buf_floats;            // kCumBatch x se: exp(cum)
  float* dk = ec + kCumBatch * se;            // kCumBatch: exp(cum_{L-1})

  const int hb = blockIdx.x, b = hb / H, h = hb - b * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mts = pp / 16, p0 = 16 * (warp % mts), n0 = 8 * (warp / mts);
  const long long PN = static_cast<long long>(P) * N;
  const Scratch s = scratch_of(a, NC);
  const T* dt = static_cast<const T*>(a.dt);
  const T* cm = static_cast<const T*>(a.c);
  const float neg_a = -a.a[h];
  // the 8-column tiles of N this warp carries
  const unsigned valid = (1u << min(8, max(0, np / 8 - n0))) - 1;

  // this lane's elements of the carry: rows p0 + g (+ 8), columns
  // 8 (n0 + i) + 2t (+ 1)
  float carry[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + g + (e >> 1) * 8, n = (n0 + i) * 8 + 2 * t + (e & 1);
      carry[i][e] = (a.dstate && p < P && n < N)
                        ? a.dstate[hb * PN + p * N + n] : 0.f;
    }
  }
  const auto stage_chunk = [&](int c, int buf) {
    const int rows = min(L, a.S - c * L);
    const long long tok0 = static_cast<long long>(b) * a.S + c * L;
    float* dyb = sm + buf * buf_floats;
    stage_tile<float>(dyb, sdy, a.dy + (tok0 * H + h) * P,
                      static_cast<long long>(H) * P, rows, lt, P, pp,
                      flags & kVecDy);
    stage_tile<T>(reinterpret_cast<T*>(dyb + lt * sdy), sc, cm + tok0 * N,
                  N, rows, lt, N, np, flags & kVecBC);
    cp_async_commit();
  };

  stage_chunk(NC - 1, 0);
  for (int k = 0; k < NC; ++k) {
    const int c = NC - 1 - k, buf = k & 1, slot = k % kCumBatch;
    if (slot == 0) {
      // the exp(cumsum)s of chunks c, c - 1, ..., c - 15 (row i: c - i),
      // once every warp is done with the last batch's: their dt loaded by
      // every thread, each cumsum summed in order by a lane of warp 0
      const int nb = min(kCumBatch, c + 1);
      __syncthreads();
      for (int i = threadIdx.x; i < nb * lt; i += blockDim.x) {
        const int r = i / lt, u = i - r * lt, cc = c - r;
        ec[r * se + u] = u < min(L, a.S - cc * L)
            ? to_f32(dt[(static_cast<long long>(b) * a.S + cc * L + u) * H +
                        h])
            : 0.f;
      }
      __syncthreads();
      if (warp == 0 && lane < nb) {
        float* e = ec + lane * se;
        float run = 0.f;
        for (int u = 0; u < lt; ++u) {
          run += neg_a * e[u];
          e[u] = run;
        }
        dk[lane] = expf(run);
      }
      __syncthreads();
      for (int i = threadIdx.x; i < nb * lt; i += blockDim.x) {
        const int r = i / lt;
        ec[r * se + i - r * lt] = expf(ec[r * se + i - r * lt]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // chunk c's tiles; the other buffer is free
    if (c > 0) stage_chunk(c - 1, buf ^ 1);

    // dS of chunk c = the carry
    float* out = s.ds + ((static_cast<long long>(b) * NC + c) * H + h) * PN;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + g + (e >> 1) * 8;
        const int n = (n0 + i) * 8 + 2 * t + (e & 1);
        if (p < P && n < N) out[p * N + n] = carry[i][e];
      }
    }
    const float d = dk[slot];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) carry[i][e] *= d;
    }
    // carry += (exp(cum) dy)^T C: k = t, t + 4 <-> steps 2t, 2t + 1
    const float* dyt = sm + buf * buf_floats;
    const T* ct = reinterpret_cast<const T*>(dyt + lt * sdy);
    const float* e = ec + slot * se;
    for (int k0 = 0; k0 < lt; k0 += 8) {
      const int ta = k0 + 2 * t, tb = ta + 1;
      const float ea = e[ta], eb = e[tb];
      const float* ya = dyt + ta * sdy + p0 + g;
      const float* yb = dyt + tb * sdy + p0 + g;
      uint32_t ah[4], al[4];
      split_frag<false>(ea * ya[0], ea * ya[8], eb * yb[0], eb * yb[8], ah,
                        al);
      float b0[8], b1[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = min((n0 + i) * 8, np - 8) + g;
        b0[i] = to_f32(ct[ta * sc + col]);
        b1[i] = to_f32(ct[tb * sc + col]);
      }
      mma_tiles<false, kBf16, 8>(carry, ah, al, b0, b1, valid);
    }
  }
  if (a.dinit) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + g + (e >> 1) * 8;
        const int n = (n0 + i) * 8 + 2 * t + (e & 1);
        if (p < P && n < N) a.dinit[hb * PN + p * N + n] = carry[i][e];
      }
    }
  }
}

// ------------------------------------------ 2. the chunks' gradients
// Warp w takes the row tile m = w % 4 (steps 16m .. 16m + 15) and
// the 8-column tiles j, j + 4, ... (j = w / 4) of every product's output;
// kW is the most such tiles of P or N (2 up to 64, 4 up to 128).  Its Q /
// D tiles are j and j + 4 where they touch the lower triangle, which
// spreads the triangle's 20 tiles (L = 64) as 0-2 a warp.  kLT, kPP, kNP
// as the state kernel's.
template <typename T, int kW, int kLT, int kPP, int kNP>
__global__ void __launch_bounds__(kScanThreads)
    ssd_scan_bwd_kernel(SsdBwdArgs a, int NC, int sets, int flags) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sm = reinterpret_cast<float*>(smem);
  const int L = a.L, P = a.P, N = a.N, H = a.H, G = a.groups;
  const int lt = padded<kLT>(L), pp = padded<kPP>(P), np = padded<kNP>(N);
  const int sn = np + 8, scb = lt + 4, sx = pp + 8, sdy = pp + 4;
  const int sst = np + 4;
  const ScanSmem lay = scan_smem(L, P, N, sets);
  float* cs = sm + lay.c;      // C (t, n)
  float* bs = sm + lay.b;      // B (u, n)
  float* cb = sm + lay.cb;     // C B^T (t, u); at the end the heads' D
  float* em = sm + lay.e;      // exp(cum_t - cum_u) (t, u), 0 for u > t
  const int pf = part_floats(lt);

  const int q = blockIdx.x / G, grp = blockIdx.x - q * G;
  const int b = q / NC, c = q - b * NC;
  const int h_lo = grp * H / G, h_hi = (grp + 1) * H / G;
  const int t0 = c * L, rows = min(L, a.S - t0);
  const long long tok0 = static_cast<long long>(b) * a.S + t0;
  const long long bnc = static_cast<long long>(b) * NC + c;
  const long long PN = static_cast<long long>(P) * N;
  const Scratch s = scratch_of(a, NC);
  const T* x = static_cast<const T*>(a.x);
  const T* dt = static_cast<const T*>(a.dt);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m = warp & 3, j = warp >> 2;
  const int r0 = 16 * m, tr0 = r0 + g, tr1 = tr0 + 8;   // this lane's rows
  const bool active = r0 < lt;
  // this warp's 8-column tiles j + 4i of the triangle (Q, D), of N and of P
  const unsigned qvalid = (j <= 2 * m + 1 ? 1u : 0u) |
                          (j + 4 <= 2 * m + 1 ? 2u : 0u);
  unsigned nvalid = 0, pvalid = 0;
#pragma unroll
  for (int i = 0; i < kW; ++i) {
    nvalid |= ((j + 4 * i) * 8 < np ? 1u : 0u) << i;
    pvalid |= ((j + 4 * i) * 8 < pp ? 1u : 0u) << i;
  }

  const auto stage_head = [&](int h, int set) {
    stage_tile<T>(reinterpret_cast<T*>(sm + lay.x[set]), sx,
                  x + (tok0 * H + h) * P, static_cast<long long>(H) * P,
                  rows, lt, P, pp, flags & kVecX);
    stage_tile<float>(sm + lay.dy[set], sdy, a.dy + (tok0 * H + h) * P,
                      static_cast<long long>(H) * P, rows, lt, P, pp,
                      flags & kVecDy);
    const long long st = (bnc * H + h) * PN;
    stage_tile<float>(sm + lay.bf[set], sst, a.states + st, N, P, pp, N, np,
                      flags & kVecStates);
    stage_tile<float>(sm + lay.ds[set], sst, s.ds + st, N, P, pp, N, np,
                      flags & kVecStates);
    cp_async_commit();
  };
  // step u of head h's dt (0 past the chunk)
  const auto dt_of = [&](int h, int u) {
    return u < rows ? to_f32(dt[(tok0 + u) * H + h]) : 0.f;
  };
  // by one warp, from head h's dt at steps lane and lane + 32: its cumsum
  // (in order, by one lane), exp(cum) and tail, into vec
  const auto cum_step = [&](int h, float* vec, float d0, float d1) {
    float* dts = vec;
    float* cum = vec + lt;
    if (lane < lt) dts[lane] = d0;
    if (lane + 32 < lt) dts[lane + 32] = d1;
    __syncwarp();
    if (lane == 0) chunk_cumsum(dts, cum, lt, -a.a[h]);
    __syncwarp();
    const float last = cum[lt - 1];
    for (int u = lane; u < lt; u += 32) {
      vec[2 * lt + u] = expf(cum[u]);
      vec[3 * lt + u] = expf(last - cum[u]);
    }
  };
  // by one warp, head h's d cum from the warps' partials (steps lane and
  // lane + 32), its reverse cumsum dla as a suffix scan (a fixed order),
  // ddt and da's part
  const auto tail_step = [&](int h, const float* pt, const float* vec) {
    const float* dts = vec;
    const float* tail = vec + 3 * lt;
    float dc[2] = {0.f, 0.f}, gd[2] = {0.f, 0.f}, tails = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int u = lane + 32 * i;
      if (u < lt) {
        float rs = 0.f, rr = 0.f, cl = 0.f;
        for (int q = 0; q < 4; ++q) {
          rs += pt[q * lt + u];
          rr += pt[(4 + q) * lt + u];
          gd[i] += pt[(8 + q) * lt + u];
        }
        for (int q = 0; q < lt / 16; ++q) cl += pt[(12 + q) * lt + u];
        const float tt = tail[u] * dts[u] * rr;
        tails += tt;
        dc[i] = rs - cl - tt;
      }
    }
    tails = warp_sum(tails);
    const float dot = warp_sum(lane < kMmaWarps ? pt[16 * lt + lane] : 0.f);
    // the tails' and the chunk decay's terms on the last step
    if (lane == (lt - 1) % 32) {
      dc[(lt - 1) / 32] += tails + expf(vec[lt + lt - 1]) * dot;
    }
    float run[2] = {dc[0], dc[1]};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_down_sync(0xffffffffu, run[i], off);
        if (lane + off < 32) run[i] += y;
      }
    }
    run[0] += __shfl_sync(0xffffffffu, run[1], 0);
    const float neg_a = -a.a[h];
    T* ddt = static_cast<T*>(a.ddt);
    float da = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int u = lane + 32 * i;
      if (u < rows) {
        ddt[(tok0 + u) * H + h] = from_f32<T>(gd[i] + neg_a * run[i]);
        da = fmaf(dts[u], run[i], da);
      }
    }
    da = warp_sum(da);
    if (lane == 0) s.da[bnc * H + h] = -da;
  };

  // D and the inter terms of dC and dB, summed over the CTA's heads
  float dsum[2][4] = {}, dci[kW][4] = {}, dbi[kW][4] = {};
  // a head: its products, its D, its partials into pt
  const auto head_products = [&](int h, int set, const float* vec,
                                 float* pt) {
    const T* xs = reinterpret_cast<const T*>(sm + lay.x[set]);
    const float* dys = sm + lay.dy[set];
    const float* bfs = sm + lay.bf[set];
    const float* dss = sm + lay.ds[set];
    const float* dts = vec;
    const float* ecum = vec + 2 * lt;
    const float* tail = vec + 3 * lt;
    // <dS, before[c]>: a part a warp (the pads are zeros in both)
    float dot = 0.f;
    for (int p = warp; p < pp; p += kMmaWarps) {
      for (int n = lane; n < np; n += 32) {
        dot = fmaf(dss[p * sst + n], bfs[p * sst + n], dot);
      }
    }
    dot = warp_sum(dot);
    if (lane == 0) pt[16 * lt + warp] = dot;
    if (!active) return;

    uint32_t ah[4], al[4];
    // Q = dy x^T on this warp's triangle tiles, Z = dy before on its
    // N tiles: k over p
    float qa[2][4] = {}, za[kW][4] = {};
    for (int k0 = 0; k0 < pp; k0 += 8) {
      const float2 v0 = ld2(dys + tr0 * sdy + k0 + 2 * t);
      const float2 v1 = ld2(dys + tr1 * sdy + k0 + 2 * t);
      split_frag<false>(v0.x, v1.x, v0.y, v1.y, ah, al);
      float q0[2], q1[2], z0[kW], z1[kW];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 xv = ld2(xs + (min(j + 4 * i, 2 * m + 1) * 8 + g) * sx +
                              k0 + 2 * t);
        q0[i] = xv.x;
        q1[i] = xv.y;
      }
#pragma unroll
      for (int i = 0; i < kW; ++i) {
        const float* bp =
            bfs + (k0 + 2 * t) * sst + min((j + 4 * i) * 8, np - 8) + g;
        z0[i] = bp[0];
        z1[i] = bp[sst];
      }
      mma_tiles<false, kBf16, 2>(qa, ah, al, q0, q1, qvalid);
      mma_tiles<false, false, kW>(za, ah, al, z0, z1, nvalid);
    }
    // D = Q dt_u exp(cum_t - cum_u) on the triangle; this lane's part of
    // (CB o D)'s row sums, its column sums over the tile's 16 rows
    float rs0 = 0.f, rs1 = 0.f;
    float* colp = pt + (12 + m) * lt;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int nt = j + 4 * i;
      if (nt * 8 >= lt) continue;
      const int u = nt * 8 + 2 * t;
      float col0 = 0.f, col1 = 0.f;
      if (nt <= 2 * m + 1) {
        const float du0 = dts[u], du1 = dts[u + 1];
        const float2 e0 = ld2(em + tr0 * scb + u);
        const float2 e1 = ld2(em + tr1 * scb + u);
        const float d[4] = {qa[i][0] * du0 * e0.x, qa[i][1] * du1 * e0.y,
                            qa[i][2] * du0 * e1.x, qa[i][3] * du1 * e1.y};
        const float2 w0 = ld2(cb + tr0 * scb + u);
        const float2 w1 = ld2(cb + tr1 * scb + u);
        const float r00 = w0.x * d[0], r01 = w0.y * d[1];
        const float r10 = w1.x * d[2], r11 = w1.y * d[3];
        rs0 += r00 + r01;
        rs1 += r10 + r11;
        col0 = r00 + r10;
        col1 = r01 + r11;
#pragma unroll
        for (int e = 0; e < 4; ++e) dsum[i][e] += d[e];
      }
      for (int off = 4; off < 32; off <<= 1) {
        col0 += __shfl_xor_sync(0xffffffffu, col0, off);
        col1 += __shfl_xor_sync(0xffffffffu, col1, off);
      }
      if (g == 0) {
        colp[u] = col0;
        colp[u + 1] = col1;
      }
    }
    // the inter terms: exp(cum_t) C_t . Z_t of d cum, exp(cum_t) Z of dC
    const float e0 = ecum[tr0], e1 = ecum[tr1];
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      const int nt = j + 4 * i;
      if (nt * 8 < np) {
        const int n = nt * 8 + 2 * t;
        const float2 q0 = ld2(cs + tr0 * sn + n), q1 = ld2(cs + tr1 * sn + n);
        rs0 += e0 * (q0.x * za[i][0] + q0.y * za[i][1]);
        rs1 += e1 * (q1.x * za[i][2] + q1.y * za[i][3]);
        dci[i][0] += e0 * za[i][0];
        dci[i][1] += e0 * za[i][1];
        dci[i][2] += e1 * za[i][2];
        dci[i][3] += e1 * za[i][3];
      }
    }
    // x^T dS (rows u, N tiles) into dB's inter term with tail_u dt_u
    {
      float xa[kW][4] = {};
      for (int k0 = 0; k0 < pp; k0 += 8) {
        const float2 v0 = ld2(xs + tr0 * sx + k0 + 2 * t);
        const float2 v1 = ld2(xs + tr1 * sx + k0 + 2 * t);
        split_frag<kBf16>(v0.x, v1.x, v0.y, v1.y, ah, al);
        float b0[kW], b1[kW];
#pragma unroll
        for (int i = 0; i < kW; ++i) {
          const float* dp =
              dss + (k0 + 2 * t) * sst + min((j + 4 * i) * 8, np - 8) + g;
          b0[i] = dp[0];
          b1[i] = dp[sst];
        }
        mma_tiles<kBf16, false, kW>(xa, ah, al, b0, b1, nvalid);
      }
      const float w0 = tail[tr0] * dts[tr0], w1 = tail[tr1] * dts[tr1];
#pragma unroll
      for (int i = 0; i < kW; ++i) {
        dbi[i][0] += w0 * xa[i][0];
        dbi[i][1] += w0 * xa[i][1];
        dbi[i][2] += w1 * xa[i][2];
        dbi[i][3] += w1 * xa[i][3];
      }
    }
    // dS B (rows u, P tiles): k over n
    float ga[kW][4] = {};
    for (int k0 = 0; k0 < np; k0 += 8) {
      const float2 v0 = ld2(bs + tr0 * sn + k0 + 2 * t);
      const float2 v1 = ld2(bs + tr1 * sn + k0 + 2 * t);
      split_frag<kBf16>(v0.x, v1.x, v0.y, v1.y, ah, al);
      float b0[kW], b1[kW];
#pragma unroll
      for (int i = 0; i < kW; ++i) {
        const float2 sv =
            ld2(dss + (min((j + 4 * i) * 8, pp - 8) + g) * sst + k0 + 2 * t);
        b0[i] = sv.x;
        b1[i] = sv.y;
      }
      mma_tiles<kBf16, false, kW>(ga, ah, al, b0, b1, pvalid);
    }
    // x . dS B; gx = tail_u dS B + W^T dy, k over t >= 16 m
    float rr0 = 0.f, rr1 = 0.f;
    const float tl0 = tail[tr0], tl1 = tail[tr1];
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      const int p = (j + 4 * i) * 8 + 2 * t;
      if (p < pp) {
        const float2 x0 = ld2(xs + tr0 * sx + p), x1 = ld2(xs + tr1 * sx + p);
        rr0 += x0.x * ga[i][0] + x0.y * ga[i][1];
        rr1 += x1.x * ga[i][2] + x1.y * ga[i][3];
      }
      ga[i][0] *= tl0;
      ga[i][1] *= tl0;
      ga[i][2] *= tl1;
      ga[i][3] *= tl1;
    }
    for (int k0 = r0; k0 < lt; k0 += 8) {
      const int ta = k0 + 2 * t, tb = ta + 1;
      const float* wa = cb + ta * scb;
      const float* wb = cb + tb * scb;
      const float* ea = em + ta * scb;
      const float* eb = em + tb * scb;
      split_frag<false>(wa[tr0] * ea[tr0], wa[tr1] * ea[tr1],
                        wb[tr0] * eb[tr0], wb[tr1] * eb[tr1], ah, al);
      float b0[kW], b1[kW];
#pragma unroll
      for (int i = 0; i < kW; ++i) {
        const float* yp = dys + ta * sdy + min((j + 4 * i) * 8, pp - 8) + g;
        b0[i] = yp[0];
        b1[i] = yp[sdy];
      }
      mma_tiles<false, false, kW>(ga, ah, al, b0, b1, pvalid);
    }
    // x . gx; dx = dt_u gx
    float gd0 = 0.f, gd1 = 0.f;
    const float d0 = dts[tr0], d1 = dts[tr1];
    T* dx = static_cast<T*>(a.dx);
    T* dx0 = dx + ((tok0 + tr0) * H + h) * P;
    T* dx1 = dx + ((tok0 + tr1) * H + h) * P;
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      const int p = (j + 4 * i) * 8 + 2 * t;
      if (p < pp) {
        const float2 x0 = ld2(xs + tr0 * sx + p), x1 = ld2(xs + tr1 * sx + p);
        gd0 += x0.x * ga[i][0] + x0.y * ga[i][1];
        gd1 += x1.x * ga[i][2] + x1.y * ga[i][3];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (p + e < P) {
            if (tr0 < rows) dx0[p + e] = from_f32<T>(d0 * ga[i][e]);
            if (tr1 < rows) dx1[p + e] = from_f32<T>(d1 * ga[i][2 + e]);
          }
        }
      }
    }
    // this warp's parts of rows tr0 and tr1
    rs0 = quad_sum(rs0);
    rs1 = quad_sum(rs1);
    rr0 = quad_sum(rr0);
    rr1 = quad_sum(rr1);
    gd0 = quad_sum(gd0);
    gd1 = quad_sum(gd1);
    if (t == 0) {
      pt[j * lt + tr0] = rs0;
      pt[j * lt + tr1] = rs1;
      pt[(4 + j) * lt + tr0] = rr0;
      pt[(4 + j) * lt + tr1] = rr1;
      pt[(8 + j) * lt + tr0] = gd0;
      pt[(8 + j) * lt + tr1] = gd1;
    }
  };

  // C and B (f32), the first head's tiles and cumsum; C B^T on the
  // triangle's tiles
  const T* cm = static_cast<const T*>(a.c);
  const T* bm = static_cast<const T*>(a.b);
  stage_tile<float>(cs, sn, cm + tok0 * N, N, rows, lt, N, np,
                    flags & kVecBC);
  stage_tile<float>(bs, sn, bm + tok0 * N, N, rows, lt, N, np,
                    flags & kVecBC);
  cp_async_commit();
  stage_head(h_lo, 0);
  float* vecs = sm + lay.vecs;
  float* parts = sm + lay.parts;
  const auto vec_of = [&](int h) { return vecs + (h - h_lo) % 3 * 4 * lt; };
  if (warp == kCumWarp) {
    cum_step(h_lo, vec_of(h_lo), dt_of(h_lo, lane), dt_of(h_lo, lane + 32));
  }
  cp_async_wait<1>();
  __syncthreads();
  if (active) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int nt = j + 4 * i;
      if (nt <= 2 * m + 1) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        cb_tile<kBf16>(acc, cs + r0 * sn, bs + nt * 8 * sn, sn, np, g, t);
        float* o = cb + tr0 * scb + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(o) = make_float2(acc[0], acc[1]);
        *reinterpret_cast<float2*>(o + 8 * scb) = make_float2(acc[2], acc[3]);
      }
    }
  }

  for (int h = h_lo; h < h_hi; ++h) {
    const int cur = (h - h_lo) & 1, nxt = cur ^ 1;
    cp_async_wait<0>();
    // head h's tiles and cumsum, head h - 1's partials, C B^T
    __syncthreads();
    if (sets == 2 && h + 1 < h_hi) stage_head(h + 1, nxt);
    {
      // head h's decays, each exp taken once
      const float* cum = vec_of(h) + lt;
      for (int tt = warp; tt < lt; tt += kMmaWarps) {
        for (int u = lane; u < lt; u += 32) {
          em[tt * scb + u] = u <= tt ? expf(cum[tt] - cum[u]) : 0.f;
        }
      }
    }
    __syncthreads();   // the decays
    // the next head's dt, in flight during this head's products
    float dn0 = 0.f, dn1 = 0.f;
    if (warp == kCumWarp && h + 1 < h_hi) {
      dn0 = dt_of(h + 1, lane);
      dn1 = dt_of(h + 1, lane + 32);
    }
    head_products(h, sets == 2 ? cur : 0, vec_of(h), parts + cur * pf);
    if (warp == kTailWarp && h > h_lo) {
      tail_step(h - 1, parts + nxt * pf, vec_of(h - 1));
    }
    if (warp == kCumWarp && h + 1 < h_hi) {
      cum_step(h + 1, vec_of(h + 1), dn0, dn1);
    }
    if (sets == 1 && h + 1 < h_hi) {
      __syncthreads();   // every warp is done with the one set
      stage_head(h + 1, 0);
    }
  }
  __syncthreads();   // the last head's partials; C B^T is read no more
  if (warp == kTailWarp) {
    tail_step(h_hi - 1, parts + ((h_hi - 1 - h_lo) & 1) * pf,
              vec_of(h_hi - 1));
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int nt = j + 4 * i;
      if (nt * 8 < lt) {
        float* o = cb + tr0 * scb + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(o) = make_float2(dsum[i][0], dsum[i][1]);
        *reinterpret_cast<float2*>(o + 8 * scb) =
            make_float2(dsum[i][2], dsum[i][3]);
      }
    }
  }
  __syncthreads();   // the heads' D over C B^T
  if (!active) return;
  uint32_t ah[4], al[4];
  // dC = D B + the inter terms: k over u < 16 (m + 1)
  for (int k0 = 0; k0 < r0 + 16; k0 += 8) {
    const float2 v0 = ld2(cb + tr0 * scb + k0 + 2 * t);
    const float2 v1 = ld2(cb + tr1 * scb + k0 + 2 * t);
    split_frag<false>(v0.x, v1.x, v0.y, v1.y, ah, al);
    float b0[kW], b1[kW];
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      const float* bp =
          bs + (k0 + 2 * t) * sn + min((j + 4 * i) * 8, np - 8) + g;
      b0[i] = bp[0];
      b1[i] = bp[sn];
    }
    mma_tiles<false, kBf16, kW>(dci, ah, al, b0, b1, nvalid);
  }
  // dB = D^T C + the inter terms: k over t >= 16 m
  for (int k0 = r0; k0 < lt; k0 += 8) {
    const float* ra = cb + (k0 + 2 * t) * scb;
    const float* rb = ra + scb;
    split_frag<false>(ra[tr0], ra[tr1], rb[tr0], rb[tr1], ah, al);
    float b0[kW], b1[kW];
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      const float* cp =
          cs + (k0 + 2 * t) * sn + min((j + 4 * i) * 8, np - 8) + g;
      b0[i] = cp[0];
      b1[i] = cp[sn];
    }
    mma_tiles<false, kBf16, kW>(dbi, ah, al, b0, b1, nvalid);
  }
  // this CTA's dB / dC partials, (L, N), written once
  float* pdb = s.db + static_cast<long long>(blockIdx.x) * L * N;
  float* pdc = s.dc + static_cast<long long>(blockIdx.x) * L * N;
#pragma unroll
  for (int i = 0; i < kW; ++i) {
    const int n = (j + 4 * i) * 8 + 2 * t;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (n + e < N) {
        if (tr0 < L) {
          pdc[tr0 * N + n + e] = dci[i][e];
          pdb[tr0 * N + n + e] = dbi[i][e];
        }
        if (tr1 < L) {
          pdc[tr1 * N + n + e] = dci[i][2 + e];
          pdb[tr1 * N + n + e] = dbi[i][2 + e];
        }
      }
    }
  }
}

// ------------------------------------------------- 3. the fixed-order sums
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
    ssd_bwd_sum_kernel(SsdBwdArgs a, int NC) {
  const Scratch s = scratch_of(a, NC);
  const long long bsn = static_cast<long long>(a.B) * a.S * a.N;
  const long long i = static_cast<long long>(blockIdx.x) * kSumThreads +
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
cudaError_t launch(void (*kernel)(Exp...), long long ctas, int threads,
                   size_t smem, cudaStream_t stream, Act... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ctas));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = nullptr;
  cfg.numAttrs = 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the state and chunk-scan kernels built for padded widths kLT, kPP, kNP
// (0: any)
template <typename T, int kW, int kLT, int kPP, int kNP>
cudaError_t launch_shape(const SsdBwdArgs& a, int NC, int flags,
                         cudaStream_t stream) {
  size_t smem = state_smem_bytes(a.L, a.P, a.N);
  cudaError_t err =
      allow_smem<ssd_bwd_state_kernel<T, kLT, kPP, kNP>>(smem);
  if (err != cudaSuccess) return err;
  err = launch(ssd_bwd_state_kernel<T, kLT, kPP, kNP>,
               static_cast<long long>(a.B) * a.H, state_threads(a.P, a.N),
               smem, stream, a, NC, flags);
  if (err != cudaSuccess) return err;
  const int sets = scan_sets(a.L, a.P, a.N);
  smem = scan_smem_bytes(a.L, a.P, a.N, sets);
  err = allow_smem<ssd_scan_bwd_kernel<T, kW, kLT, kPP, kNP>>(smem);
  if (err != cudaSuccess) return err;
  return launch(ssd_scan_bwd_kernel<T, kW, kLT, kPP, kNP>,
                static_cast<long long>(a.B) * NC * a.groups, kScanThreads,
                smem, stream, a, NC, sets, flags);
}

template <typename T>
cudaError_t launch_typed(const SsdBwdArgs& a, cudaStream_t stream) {
  const int NC = (a.S + a.L - 1) / a.L;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int flags =
      ((a.P * sizeof(T)) % 16 == 0 && aligned(a.x) ? kVecX : 0) |
      (a.P % 4 == 0 && aligned(a.dy) ? kVecDy : 0) |
      (a.N % 4 == 0 && aligned(a.states) && aligned(a.scratch) ? kVecStates
                                                                : 0) |
      ((a.N * sizeof(T)) % 16 == 0 && aligned(a.b) && aligned(a.c) ? kVecBC
                                                                    : 0);
  // zamba2's and mamba2's widths at the full chunk get kernels built for
  // them; any other shape the general ones
  const int lt = pad16(a.L), pp = pad16(a.P), np = pad16(a.N);
  cudaError_t err;
  if (lt == 64 && pp == 64 && np == 64) {
    err = launch_shape<T, 2, 64, 64, 64>(a, NC, flags, stream);
  } else if (lt == 64 && pp == 64 && np == 128) {
    err = launch_shape<T, 4, 64, 64, 128>(a, NC, flags, stream);
  } else if (pp <= 64 && np <= 64) {
    err = launch_shape<T, 2, 0, 0, 0>(a, NC, flags, stream);
  } else {
    err = launch_shape<T, 4, 0, 0, 0>(a, NC, flags, stream);
  }
  if (err != cudaSuccess) return err;
  const long long sums = 2LL * a.B * a.S * a.N + a.H;
  return launch(ssd_bwd_sum_kernel<T>, (sums + kSumThreads - 1) / kSumThreads,
                kSumThreads, 0, stream, a, NC);
}

}  // namespace

cudaError_t launch_ssd_scan_bwd(const SsdBwdArgs& a, int dtype,
                                cudaStream_t stream) {
  if (a.L <= 0 || a.L > kMaxL || a.P <= 0 || a.P > kMaxP || a.N <= 0 ||
      a.N > kMaxN || a.B <= 0 || a.H <= 0 || a.S <= 0 || a.groups <= 0 ||
      a.groups > a.H || a.scratch == nullptr || a.states == nullptr ||
      scan_sets(a.L, a.P, a.N) == 0) {
    return cudaErrorInvalidValue;
  }
  if (dtype == kBF16) return launch_typed<__nv_bfloat16>(a, stream);
  if (dtype != kF32) return cudaErrorInvalidValue;
  return launch_typed<float>(a, stream);
}

}  // namespace repro
