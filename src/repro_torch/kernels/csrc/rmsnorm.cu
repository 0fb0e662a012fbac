// RMSNorm: y = x * rsqrt(mean(x^2) + eps) * w over each row, in f32.
//
// Replaces the Pallas kernel src/repro/kernels/rmsnorm.py::_rmsnorm_kernel
// (a (block_rows x d) VMEM tile per grid step).  The output has x's type
// (the Pallas kernel always writes f32; the model's rmsnorm returns x's
// type, which is what the port calls it for); the weight is read in its own
// type, f32 or bf16, so the wrapper casts nothing.
//
// Bound on the card: bytes.  Each element is read from device memory once
// and written once; 4 flops an element are far below the card's rate.  So
// the design reads each row once, keeps it in registers for the second
// pass, and moves it in 16-byte vectors:
//   * a thread holds K vectors of VEC elements (VEC = 16 bytes of x, or 1
//     when the row's byte width or a pointer does not allow 16-byte
//     accesses: bf16 d = 20, any odd d);
//   * narrow rows (up to 32 * 4 vectors) take one warp each, 4 rows a CTA,
//     and reduce with warp shuffles alone;
//   * wider rows take one CTA each, sized to the row (the fewest of K = 4,
//     8, 16 that hold it in 256 threads, so ~1,000 rows of 5,120 f32 run
//     in one wave; else K = 16 in up to 512 threads: rows of up to 8,192
//     vectors), and reduce with a warp shuffle and one shared-memory round
//     (block_reduce).
// kernels/rmsnorm.py::plan picks VEC, K, the threads and the rows a CTA;
// the launch below checks that they cover the row.  At the serving path's
// shapes (d = 2560 or 5120, 8 to ~1,000 rows) the wrapper's host work is a
// large part of a call, so the wrapper does little besides the launch.
#include <cuda_bf16.h>
#include <stdint.h>

#include "block.cuh"
#include "dtype.cuh"
#include "kernels.h"

namespace repro {
namespace {

constexpr int kMaxThreads = 512;

// N values moved as one access (two 16-byte ones for 8 f32 weights)
template <typename T, int N>
struct alignas(sizeof(T) * N < 16 ? sizeof(T) * N : 16) Pack {
  T v[N];
};

// K <= 8: at most 256 threads, and a thread held to 51 registers so that
// 5 CTAs of 256 threads (8 of 160) share an SM: the ~1,000 rows of 5,120
// f32 of a prefill run in one wave.  K = 16: up to 512 threads.
template <typename T, typename W, int VEC, int K, bool kWarpRow>
__global__ void __launch_bounds__(K > 8 ? kMaxThreads : 256, K > 8 ? 1 : 5)
    rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w,
                   T* __restrict__ out, int rows, int d, float eps) {
  __shared__ float sh[32];
  int row, lane, width;
  if constexpr (kWarpRow) {
    row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    lane = threadIdx.x & 31;
    width = 32;
    if (row >= rows) return;   // the whole warp: it owns the row
  } else {
    row = blockIdx.x;
    lane = threadIdx.x;
    width = blockDim.x;
  }
  const int nv = d / VEC;      // VEC > 1 only where it divides d
  const Pack<T, VEC>* xr =
      reinterpret_cast<const Pack<T, VEC>*>(x + static_cast<long long>(row) * d);
  Pack<T, VEC> v[K];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = lane + k * width;
    if (i < nv) {
      v[k] = xr[i];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float f = to_f32(v[k].v[j]);
        ss += f * f;
      }
    }
  }
  if constexpr (kWarpRow) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(kFullMask, ss, o);
  } else {
    ss = block_reduce(ss, SumFloatOp(), sh);
  }
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
  const Pack<W, VEC>* wr = reinterpret_cast<const Pack<W, VEC>*>(w);
  Pack<T, VEC>* yr =
      reinterpret_cast<Pack<T, VEC>*>(out + static_cast<long long>(row) * d);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = lane + k * width;
    if (i < nv) {
      const Pack<W, VEC> wv = wr[i];
      Pack<T, VEC> o;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        o.v[j] = from_f32<T>(to_f32(v[k].v[j]) * inv * to_f32(wv.v[j]));
      }
      yr[i] = o;
    }
  }
}

template <typename T, typename W, int VEC>
cudaError_t launch_vec(const NormArgs& a, cudaStream_t stream) {
  const T* x = static_cast<const T*>(a.x);
  const W* w = static_cast<const W*>(a.w);
  T* out = static_cast<T*>(a.out);
  if (a.rows_per_cta > 1) {
    if (a.k != 4 || a.threads != 32 * a.rows_per_cta) {
      return cudaErrorInvalidValue;
    }
    const int grid = (a.rows + a.rows_per_cta - 1) / a.rows_per_cta;
    rmsnorm_kernel<T, W, VEC, 4, true>
        <<<grid, a.threads, 0, stream>>>(x, w, out, a.rows, a.d, a.eps);
  } else if (a.k == 4) {
    rmsnorm_kernel<T, W, VEC, 4, false>
        <<<a.rows, a.threads, 0, stream>>>(x, w, out, a.rows, a.d, a.eps);
  } else if (a.k == 8) {
    rmsnorm_kernel<T, W, VEC, 8, false>
        <<<a.rows, a.threads, 0, stream>>>(x, w, out, a.rows, a.d, a.eps);
  } else if (a.k == 16) {
    rmsnorm_kernel<T, W, VEC, 16, false>
        <<<a.rows, a.threads, 0, stream>>>(x, w, out, a.rows, a.d, a.eps);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t launch_typed(const NormArgs& a, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (a.vec == 1) return launch_vec<T, W, 1>(a, stream);
  const auto aligned = [](const void* p, size_t bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  if (a.vec != kVec || a.d % kVec != 0 || !aligned(a.x, 16) ||
      !aligned(a.out, 16) || !aligned(a.w, alignof(Pack<W, kVec>))) {
    return cudaErrorInvalidValue;
  }
  return launch_vec<T, W, kVec>(a, stream);
}

}  // namespace

cudaError_t launch_rmsnorm(const NormArgs& a, cudaStream_t stream) {
  if (a.rows <= 0 || a.d <= 0) return cudaSuccess;
  const int width = a.rows_per_cta > 1 ? 32 : a.threads;
  if (a.threads < 32 || a.threads > (a.k > 8 ? kMaxThreads : 256) ||
      a.threads % 32 != 0 ||
      static_cast<long long>(width) * a.k * a.vec < a.d) {
    return cudaErrorInvalidValue;
  }
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
