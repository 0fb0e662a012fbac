// Pieces shared by the attention backward's two sources:
// flash_attention_bwd.cu (the delta pass, the f32 kernels and the entry
// point) and flash_attention_bwd_wgmma.cu (the bf16 kernels on wgmma).
#pragma once

#include <cuda_runtime.h>

#include "kernels.h"

namespace repro {
namespace {

constexpr float kLog2e = 1.4426950408889634f;
enum Which : int { kDK = 1, kDV = 2 };

// does the query at position qpos see key kj?
__device__ __forceinline__ bool seen(const AttnBwdArgs& a, int qpos,
                                     int kj) {
  return qpos < a.Sq && kj < a.Sk && (!a.causal || kj <= qpos) &&
         (a.window <= 0 || kj > qpos - a.window);
}

}  // namespace

// dK, dV and dQ of a bf16 call, after its delta pass: the kernels of
// flash_attention_bwd_wgmma.cu.  `vec`: every row starts on 16 bytes.
cudaError_t launch_flash_attention_bwd_wgmma(const AttnBwdArgs& a, int vec,
                                             cudaStream_t stream);

}  // namespace repro
