// Launch interface shared by the port's CUDA kernels and bindings.cpp.
#pragma once

#include <cuda_runtime.h>

namespace repro {

// One greedy, class-free Steps-1..3 scheduling pass over B lanes of W slots
// (row-major (B, W) tensors, slots in FCFS order).  `depth` may be null
// (unbounded EASY scan).  Outputs may not alias inputs.
struct TickArgs {
  const int* state;
  const int* alloc;
  const float* remaining;
  const float* start_t;
  const unsigned char* act;
  const unsigned char* malleable;
  const int* want;
  const int* floor_nodes;
  const int* shrink_floor;
  const int* prio_ref;
  const int* max_nodes;
  const float* pfrac;
  const float* wall_work;
  const int* capacity;  // (B,)
  const float* t_now;   // (B,)
  const int* depth;     // (B,) or null
  int* out_state;
  int* out_alloc;
  float* out_start;
  int B;
  int W;
  int fill_rounds;
  int prio_lo;
  int prio_hi;
  int shadow_iters;
  // take_desc_prefix bounds (lo, hi] and bisection rounds for the Step-2
  // shrink and the Step-3 give (computed on the host exactly as the JAX
  // pass does: ceil(log2(max(hi - lo, 1))) + 1)
  int take_lo, take_hi, take_iters;
  int give_lo, give_hi, give_iters;
};

cudaError_t launch_schedule_tick(const TickArgs& args, cudaStream_t stream);

// Per-row prefix waterfill over B rows of N int32 capacities.
cudaError_t launch_waterfill(const int* cap, const int* target, int* out,
                             int B, int N, cudaStream_t stream);

}  // namespace repro
