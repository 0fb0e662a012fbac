// Block-wide scan and reductions for kernels that walk one row per CTA.
//
// Every thread of the block must call these (they synchronise), with
// blockDim.x a multiple of 32 and at most 1024.  `sh` is a 32-entry shared
// scratch array; results are returned to every thread.
#pragma once

#include <cuda_runtime.h>

namespace repro {

constexpr unsigned kFullMask = 0xffffffffu;

// Inclusive prefix sum of `v` across the block; *total gets the block sum.
__device__ __forceinline__ int block_inclusive_scan(int v, int* sh,
                                                    int* total) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFullMask, v, o);
    if (lane >= o) v += n;
  }
  __syncthreads();  // previous readers of sh are done
  if (lane == 31) sh[wid] = v;
  __syncthreads();
  int before = 0, sum = 0;
  for (int i = 0; i < nw; ++i) {
    const int s = sh[i];
    if (i < wid) before += s;
    sum += s;
  }
  *total = sum;
  return v + before;
}

template <typename T, typename Op>
__device__ __forceinline__ T block_reduce(T v, Op op, T* sh) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kFullMask, v, o));
  __syncthreads();
  if (lane == 0) sh[wid] = v;
  __syncthreads();
  T r = sh[0];
  for (int i = 1; i < nw; ++i) r = op(r, sh[i]);
  return r;
}

struct SumFloatOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return a + b; }
};

}  // namespace repro
