// Stands in for csrc/mma.cuh under the host emulation: only allow_smem.
#pragma once
#include "cuda_runtime.h"
namespace repro {
template <auto Kernel> cudaError_t allow_smem(size_t) { return cudaSuccess; }
}  // namespace repro
