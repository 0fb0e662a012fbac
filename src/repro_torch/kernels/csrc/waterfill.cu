// Prefix waterfill for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/waterfill.py::_waterfill_kernel
// (wrapper waterfill, caller repro/core/passes.py::_pallas_give): per row,
//   take[i] = clip(target - exclusive_prefix_sum(cap)[i], 0, cap[i]),
// whose sum is min(target, sum(cap)).  The TPU kernel walks 2048-element
// blocks in order with the running sum carried in SMEM; Hopper's blocks run
// in no order, so here one CTA owns a whole row and carries the prefix across
// blockDim-wide tiles of a block-wide scan.  The same kernel serves the
// engine's (B, W) per-lane rows and one long 1-D row (an Eagle-sized
// 143,829-slot queue) as B = 1.
//
// Bound on this card: memory -- 8 bytes per slot (read cap, write take) --
// but a single CTA per row reaches only one SM's share of the bandwidth; a
// decoupled look-back scan across CTAs for long rows is later work.
#include "block.cuh"
#include "kernels.h"

namespace repro {
namespace {

__global__ void waterfill_kernel(const int* __restrict__ cap,
                                 const int* __restrict__ target,
                                 int* __restrict__ out, int N) {
  __shared__ int sh[32];
  const size_t off = static_cast<size_t>(blockIdx.x) * N;
  const int tgt = target[blockIdx.x];
  int carry = 0;
  for (int base = 0; base < N; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int c = i < N ? cap[off + i] : 0;
    int tot;
    const int incl = block_inclusive_scan(c, sh, &tot);
    const int before = carry + incl - c;
    carry += tot;
    if (i < N) out[off + i] = min(max(tgt - before, 0), c);
  }
}

}  // namespace

cudaError_t launch_waterfill(const int* cap, const int* target, int* out,
                             int B, int N, cudaStream_t stream) {
  if (B <= 0 || N <= 0) return cudaSuccess;
  const int threads = N <= 512 ? 512 : 1024;
  waterfill_kernel<<<B, threads, 0, stream>>>(cap, target, out, N);
  return cudaGetLastError();
}

}  // namespace repro
