// RMSNorm's backward: dx and dscale over rows of width d.
//
// The gradient of csrc/rmsnorm.cu's function.  It replaces no TPU kernel:
// the Pallas kernel src/repro/kernels/rmsnorm.py::_rmsnorm_kernel has no
// backward, and JAX differentiates the plain ops.  Given dy (x's type):
//   r = rsqrt(mean(x^2) + eps)
//   dx = r (w dy) - x r^3 mean(x w dy)            in x's type
//   dscale = sum over rows of dy x r              in w's type
//
// Bound on the card: bytes.  x and dy are read and dx written, each once;
// ~8 flops an element are far below the card's rate.  So the design moves
// each byte once, 16 bytes an access, with enough of them in flight:
//   * fixed column ownership: a group of `tpr` threads takes a row (a warp
//     for narrow rows, else the whole CTA), and each thread owns the same K
//     vectors of VEC elements (16 bytes of x, or 1 element where d or a
//     pointer does not allow 16-byte accesses) in every row its group
//     walks.  It loads x and dy once into registers, reduces sum x^2 and
//     sum x w dy together (one shuffle tree on the pair, and one
//     shared-memory round when the row spans warps) and writes dx from the
//     registers;
//   * the next row's x and dy are loaded before the current row's
//     reduction, where two rows of them fit the registers (the plan's
//     depth 2);
//   * dscale's terms are summed in registers over every row the group
//     walks: a thread's columns never change, so nothing is exchanged per
//     element;
//   * a persistent grid (1-4 CTAs an SM, as their threads and registers
//     allow) deals the rows out in a fixed pattern: group g of G takes rows
//     g, g + G, g + 2 G, ...;
//   * the groups of a CTA add their sums into shared memory in group order,
//     and the CTAs of a thread block cluster fold theirs through
//     distributed shared memory in rank order (each CTA reads its slice of
//     the columns from every CTA of the cluster), one f32 partial row a
//     cluster; a grid of one cluster (up to 8 CTAs) writes dscale there and
//     is done, a larger one takes clusters of 2, which the card spreads 2
//     an SM;
//   * a second kernel of d / 32 CTAs adds the partial rows up: 8 warps a
//     CTA each add every 8th partial row of their 32 columns, then the 8
//     sums in warp order (up to ~33 partials a thread);
//   * rows too wide for a thread's registers (past 16,384 elements; the
//     plan's depth 0) take rmsnorm_bwd_stream_kernel: a CTA a row, walked
//     twice, the sums first, then dx (the second walk reads the row again,
//     from L2); dscale's terms go to the CTA's own f32 partial row in
//     global memory, each thread its own columns, and the second kernel
//     adds those rows up.
// Every sum runs in an order fixed by the plan, so the same inputs and plan
// give the same bits whatever order the CTAs finish in.  No float atomics.
// kernels/rmsnorm.py::bwd_plan picks VEC, K, the depth, the threads, the
// CTAs and the cluster; the launch below checks that they cover the row.
// The choices follow device times on the card (chip_smoke.py --phases
// rmsnorm-plans, and builds of this file with %globaltimer stamps or one
// step cut out, not kept): summing the partial rows in the same launch, by the last
// cluster to take an atomic ticket, cost more after the last row (a fence,
// the ticket, clearing it, a second cluster barrier) than the second
// kernel; clusters of 8 left SMs empty and others with 3 CTAs, whose rows
// ended late, where clusters of 2 spread the CTAs evenly; storing the sums
// into the owners' shared memory instead of reading them was slower, and a
// deeper register ring of rows did not help.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "dtype.cuh"
#include "kernels.h"
#include "mma.cuh"

namespace repro {
namespace {

namespace cg = cooperative_groups;

constexpr int kMaxThreads = 512;
// dynamic shared memory: two slots of a row's (sum x^2, sum x w dy) for
// each of up to 32 warps, then the CTA's d column sums
constexpr int kRedFloats = 2 * 2 * 32;
constexpr int kHeadBytes = kRedFloats * 4;

// DEPTH: the rows of x and dy a thread holds, 2 where the next row loads
// while one is reduced (kernels/rmsnorm.py's BwdPlan.depth).
template <typename T, typename W, int VEC, int K, int DEPTH>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       W* __restrict__ dw, float* __restrict__ partial,
                       int rows, int d, int tpr, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);
  float* col = reinterpret_cast<float*>(smem + kHeadBytes);
  using P = Pack<T, VEC>;
  using PW = Pack<W, VEC>;
  constexpr bool kPipe = DEPTH == 2;
  const int tid = threadIdx.x;
  const int groups = blockDim.x / tpr;
  const int group = tid / tpr, lane = tid % tpr;
  const int nv = d / VEC;      // VEC > 1 only where it divides d
  const int stride = gridDim.x * groups;
  const PW* wr = reinterpret_cast<const PW*>(w);

  float acc[K][VEC];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[k][j] = 0.f;
  }
  P xv[K], gv[K];
  const auto load = [&](int r, P* xs, P* gs) {
    const P* xr = reinterpret_cast<const P*>(x + static_cast<long long>(r) * d);
    const P* gr =
        reinterpret_cast<const P*>(dy + static_cast<long long>(r) * d);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = lane + k * tpr;
      if (i < nv) {
        xs[k] = xr[i];
        gs[k] = gr[i];
      }
    }
  };
  int row = blockIdx.x * groups + group;
  if (row < rows) load(row, xv, gv);
  for (int it = 0; row < rows; row += stride, ++it) {
    const int next = row + stride;
    P xn[K], gn[K];
    if constexpr (kPipe) {
      if (next < rows) load(next, xn, gn);
    }
    PW wv[K];
    float ss = 0.f, sg = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = lane + k * tpr;
      if (i < nv) {
        wv[k] = wr[i];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xf = to_f32(xv[k].v[j]);
          ss += xf * xf;
          sg += xf * (to_f32(wv[k].v[j]) * to_f32(gv[k].v[j]));
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      sg += __shfl_xor_sync(0xffffffffu, sg, o);
    }
    if (tpr > 32) {   // the CTA is the row's group (one barrier a row)
      float* slot = red + (it & 1) * 64;
      if ((tid & 31) == 0) {
        slot[tid >> 5] = ss;
        slot[32 + (tid >> 5)] = sg;
      }
      __syncthreads();
      ss = slot[0];
      sg = slot[32];
      for (int q = 1; q < (tpr >> 5); ++q) {
        ss += slot[q];
        sg += slot[32 + q];
      }
    }
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    const float coef = sg / static_cast<float>(d) * (r * r * r);
    P* dxr = reinterpret_cast<P*>(dx + static_cast<long long>(row) * d);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = lane + k * tpr;
      if (i < nv) {
        P o;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xf = to_f32(xv[k].v[j]);
          const float gf = to_f32(gv[k].v[j]);
          o.v[j] = from_f32<T>(r * (to_f32(wv[k].v[j]) * gf) - xf * coef);
          acc[k][j] += gf * xf * r;
        }
        dxr[i] = o;
      }
    }
    if constexpr (kPipe) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        xv[k] = xn[k];
        gv[k] = gn[k];
      }
    } else if (next < rows) {
      load(next, xv, gv);
    }
  }

  // the CTA's column sums, group by group
  for (int g = 0; g < groups; ++g) {
    if (group == g) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int i = lane + k * tpr;
        if (i < nv) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            float* c = col + i * VEC + j;
            *c = g == 0 ? acc[k][j] : *c + acc[k][j];
          }
        }
      }
    }
    __syncthreads();
  }

  // the cluster's partial row: rank q sums its slice of the columns over
  // the cluster's CTAs in rank order (a grid of one cluster writes dscale)
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  cluster.sync();
  const int span = (d + ranks - 1) / ranks;
  const int c1 = min(d, (rank + 1) * span);
  float* mine = partial + static_cast<long long>(blockIdx.x / ranks) * d;
  for (int c = rank * span + tid; c < c1; c += blockDim.x) {
    float s = cluster.map_shared_rank(col, 0)[c];
    for (int q = 1; q < ranks; ++q) s += cluster.map_shared_rank(col, q)[c];
    if (static_cast<int>(gridDim.x) == ranks) {
      dw[c] = from_f32<W>(s);
    } else {
      mine[c] = s;
    }
  }
  cluster.sync();   // no CTA leaves while another reads its col
}

// One row at a time a CTA, walked twice (rows too wide for the registers):
// the CTA takes rows b, b + G, b + 2 G, ... and adds dscale's terms of its
// rows into its own partial row, each thread its own columns.
template <typename T, typename W, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_bwd_stream_kernel(const T* __restrict__ x,
                              const W* __restrict__ w,
                              const T* __restrict__ dy, T* __restrict__ dx,
                              float* __restrict__ partial, int rows, int d,
                              float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);
  using P = Pack<T, VEC>;
  using PW = Pack<W, VEC>;
  using PF = Pack<float, VEC>;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nv = d / VEC;      // VEC > 1 only where it divides d
  const PW* wr = reinterpret_cast<const PW*>(w);
  PF* mine = reinterpret_cast<PF*>(partial +
                                   static_cast<long long>(blockIdx.x) * d);
  for (int row = blockIdx.x, it = 0; row < rows; row += gridDim.x, ++it) {
    const P* xr = reinterpret_cast<const P*>(x + static_cast<long long>(row) * d);
    const P* gr =
        reinterpret_cast<const P*>(dy + static_cast<long long>(row) * d);
    float ss = 0.f, sg = 0.f;
    for (int i = tid; i < nv; i += nt) {
      const P xv = xr[i], gv = gr[i];
      const PW wv = wr[i];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xf = to_f32(xv.v[j]);
        ss += xf * xf;
        sg += xf * (to_f32(wv.v[j]) * to_f32(gv.v[j]));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      sg += __shfl_xor_sync(0xffffffffu, sg, o);
    }
    if (nt > 32) {   // one barrier a row: two slots, as in the kernel above
      float* slot = red + (it & 1) * 64;
      if ((tid & 31) == 0) {
        slot[tid >> 5] = ss;
        slot[32 + (tid >> 5)] = sg;
      }
      __syncthreads();
      ss = slot[0];
      sg = slot[32];
      for (int q = 1; q < (nt >> 5); ++q) {
        ss += slot[q];
        sg += slot[32 + q];
      }
    }
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    const float coef = sg / static_cast<float>(d) * (r * r * r);
    P* dxr = reinterpret_cast<P*>(dx + static_cast<long long>(row) * d);
    for (int i = tid; i < nv; i += nt) {
      const P xv = xr[i], gv = gr[i];
      const PW wv = wr[i];
      P o;
      PF acc = it == 0 ? PF{} : mine[i];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xf = to_f32(xv.v[j]);
        const float gf = to_f32(gv.v[j]);
        o.v[j] = from_f32<T>(r * (to_f32(wv.v[j]) * gf) - xf * coef);
        acc.v[j] += gf * xf * r;
      }
      dxr[i] = o;
      mine[i] = acc;
    }
  }
}

// dscale from the partial rows (a launch of more than one cluster, or of
// rows walked twice): CTA b takes columns 32 b .. 32 b + 31, warp g of its
// 8 adds partial rows g, g + 8, g + 16, ... of its lane's column in order,
// and warp 0 adds the 8 warps' sums in warp order.  No thread adds more than ceil(parts / 8).
constexpr int kDwCols = 32;
constexpr int kDwGroups = 8;

template <typename W>
__global__ void __launch_bounds__(kDwCols * kDwGroups)
    rmsnorm_dw_kernel(const float* __restrict__ partial, W* __restrict__ dw,
                      int parts, int d) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sums = reinterpret_cast<float*>(smem);
  const int j = threadIdx.x % kDwCols, g = threadIdx.x / kDwCols;
  const int c = blockIdx.x * kDwCols + j;
  float s = 0.f;
  if (c < d && g < parts) {
    s = __ldcg(partial + static_cast<long long>(g) * d + c);
#pragma unroll 4
    for (int p = g + kDwGroups; p < parts; p += kDwGroups) {
      s += __ldcg(partial + static_cast<long long>(p) * d + c);
    }
  }
  sums[threadIdx.x] = s;
  __syncthreads();
  if (g == 0 && c < d) {
    float t = sums[j];
    for (int q = 1; q < kDwGroups && q < parts; ++q) t += sums[q * kDwCols + j];
    dw[c] = from_f32<W>(t);
  }
}

size_t bwd_smem(const NormBwdArgs& a) {
  return kHeadBytes + (a.depth ? sizeof(float) * static_cast<size_t>(a.d) : 0);
}

// dscale from the partial rows (none where one cluster wrote it)
template <typename W>
cudaError_t launch_dw(const NormBwdArgs& a, int parts, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.d + kDwCols - 1) / kDwCols, 1, 1);
  cfg.blockDim = dim3(kDwCols * kDwGroups, 1, 1);
  cfg.dynamicSmemBytes = sizeof(float) * kDwCols * kDwGroups;
  cfg.stream = stream;
  cudaError_t err = cudaLaunchKernelEx(&cfg, rmsnorm_dw_kernel<W>,
                                       static_cast<const float*>(a.partial),
                                       static_cast<W*>(a.dw), parts, a.d);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, typename W, int VEC, int K, int DEPTH>
cudaError_t launch_k(const NormBwdArgs& a, cudaStream_t stream) {
  if (a.k != K || a.depth != DEPTH) return cudaErrorInvalidValue;
  const auto kernel = rmsnorm_bwd_kernel<T, W, VEC, K, DEPTH>;
  const size_t smem = bwd_smem(a);
  cudaError_t err =
      allow_smem<rmsnorm_bwd_kernel<T, W, VEC, K, DEPTH>>(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.ctas, 1, 1);
  cfg.blockDim = dim3(a.threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(a.x), static_cast<const W*>(a.w),
      static_cast<const T*>(a.dy), static_cast<T*>(a.dx),
      static_cast<W*>(a.dw), a.partial, a.rows, a.d,
      a.warp_rows ? 32 : a.threads, a.eps);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess || a.ctas == a.cluster) return err;
  return launch_dw<W>(a, a.ctas / a.cluster, stream);
}

template <typename T, typename W, int VEC>
cudaError_t launch_stream(const NormBwdArgs& a, cudaStream_t stream) {
  // a CTA a row, each CTA at least one row (its partial row is written)
  if (a.warp_rows || a.cluster != 1 || a.ctas > a.rows) {
    return cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.ctas, 1, 1);
  cfg.blockDim = dim3(a.threads, 1, 1);
  cfg.dynamicSmemBytes = bwd_smem(a);
  cfg.stream = stream;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, rmsnorm_bwd_stream_kernel<T, W, VEC>, static_cast<const T*>(a.x),
      static_cast<const W*>(a.w), static_cast<const T*>(a.dy),
      static_cast<T*>(a.dx), a.partial, a.rows, a.d, a.eps);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_dw<W>(a, a.ctas, stream);
}

// The kernels there are (kernels/rmsnorm.py::bwd_plan picks among them):
// by load width, the vectors a thread holds and the rows it holds at once
// (depth 0: the row streamed twice).  Scalar accesses: 4 or 16 elements
// two rows deep, 32 one row deep; 16 bytes: 1-4 vectors two rows deep,
// and 8 f32 vectors one row deep.
template <typename T, typename W>
cudaError_t launch_typed(const NormBwdArgs& a, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (a.vec == 1) {
    if (a.depth == 0) return launch_stream<T, W, 1>(a, stream);
    switch (a.k) {
      case 4: return launch_k<T, W, 1, 4, 2>(a, stream);
      case 16: return launch_k<T, W, 1, 16, 2>(a, stream);
      case 32: return launch_k<T, W, 1, 32, 1>(a, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  const auto aligned = [](const void* p, size_t bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  if (a.vec != kVec || a.d % kVec != 0 || !aligned(a.x, 16) ||
      !aligned(a.dy, 16) || !aligned(a.dx, 16) ||
      !aligned(a.w, alignof(Pack<W, kVec>))) {
    return cudaErrorInvalidValue;
  }
  if (a.depth == 0) return launch_stream<T, W, kVec>(a, stream);
  switch (a.k) {
    case 1: return launch_k<T, W, kVec, 1, 2>(a, stream);
    case 2: return launch_k<T, W, kVec, 2, 2>(a, stream);
    case 4: return launch_k<T, W, kVec, 4, 2>(a, stream);
    case 8:
      if constexpr (kVec == 4) return launch_k<T, W, kVec, 8, 1>(a, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t launch_rmsnorm_bwd(const NormBwdArgs& a, cudaStream_t stream) {
  if (a.rows <= 0 || a.d <= 0) return cudaSuccess;
  // the plan must own every column of a row and fit the card
  const int tpr = a.warp_rows ? 32 : a.threads;
  const bool shape_ok =
      a.threads >= 32 && a.threads <= kMaxThreads && a.threads % 32 == 0 &&
      a.vec >= 1 && a.k >= 1 && a.depth >= 0 && a.depth <= 2 &&
      static_cast<long long>(tpr) * a.k * a.vec >= a.d &&
      (a.cluster == 1 || a.cluster == 2 || a.cluster == 4 ||
       a.cluster == 8) &&
      a.ctas >= a.cluster && a.ctas % a.cluster == 0 &&
      (a.partial != nullptr || (a.ctas == a.cluster && a.depth != 0)) &&
      bwd_smem(a) <= 232448;
  if (!shape_ok) return cudaErrorInvalidValue;
  if (a.dtype == kF32 && a.wdtype == kF32) {
    return launch_typed<float, float>(a, stream);
  }
  if (a.dtype == kF32 && a.wdtype == kBF16) {
    return launch_typed<float, __nv_bfloat16>(a, stream);
  }
  if (a.dtype == kBF16 && a.wdtype == kF32) {
    return launch_typed<__nv_bfloat16, float>(a, stream);
  }
  if (a.dtype == kBF16 && a.wdtype == kBF16) {
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(a, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace repro
