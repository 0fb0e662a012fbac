// Acquire loads and release stores of 64-bit words in device memory, at GPU
// scope: how CTAs of one launch hand each other a value (waterfill.cu's
// look-back descriptors).  tests/host_cuda/atomics.cuh stands in for this
// file under the host emulation.
#pragma once

#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :
               : "l"(p), "l"(v)
               : "memory");
}

}  // namespace repro
