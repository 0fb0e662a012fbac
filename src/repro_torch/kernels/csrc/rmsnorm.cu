// RMSNorm: y = x * rsqrt(mean(x^2) + eps) * w over each row, in f32.
//
// Replaces the Pallas kernel src/repro/kernels/rmsnorm.py::_rmsnorm_kernel
// (a (block_rows x d) VMEM tile per grid step).  Here one CTA normalises
// one row: a strided pass sums x^2 into f32 registers, a block reduction
// gives the mean square, and a second pass over the same row (from L1/L2,
// it was just read) scales and writes it.  Any d works; the output has x's
// type (the Pallas kernel always writes f32; the model's rmsnorm returns
// x's type, which is what the port calls it for).
//
// Bound on the card: bytes.  The kernel reads each element once from
// device memory and writes it once; 2 flops per element on the sum and 2 on
// the scale are far below the card's rate.  At the serving path's shapes
// (d = 2560 or 5120, a few to ~1,000 rows) a launch is a few microseconds,
// so the launch itself is most of the cost.
#include <cuda_bf16.h>

#include "block.cuh"
#include "dtype.cuh"
#include "kernels.h"

namespace repro {
namespace {

template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const float* __restrict__ w,
                               T* __restrict__ out, int d, float eps) {
  __shared__ float sh[32];
  const T* xr = x + static_cast<long long>(blockIdx.x) * d;
  T* yr = out + static_cast<long long>(blockIdx.x) * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
  ss = block_reduce(ss, SumFloatOp(), sh);
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    yr[i] = from_f32<T>(to_f32(xr[i]) * inv * w[i]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* w, void* out, int rows, int d,
                   float eps, cudaStream_t stream) {
  const int threads = d >= 2048 ? 256 : 128;
  rmsnorm_kernel<T><<<rows, threads, 0, stream>>>(
      static_cast<const T*>(x), w, static_cast<T*>(out), d, eps);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_rmsnorm(const void* x, const float* w, void* out, int rows,
                           int d, float eps, int dtype, cudaStream_t stream) {
  if (rows <= 0 || d <= 0) return cudaSuccess;
  if (dtype == kBF16) {
    return launch<__nv_bfloat16>(x, w, out, rows, d, eps, stream);
  }
  if (dtype != kF32) return cudaErrorInvalidValue;
  return launch<float>(x, w, out, rows, d, eps, stream);
}

}  // namespace repro
