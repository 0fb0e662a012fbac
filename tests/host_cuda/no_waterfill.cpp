// The waterfill launcher, which bindings.cpp names, refused: the tick
// kernel's host build (tests/test_torch_tick_host.py) runs without it.
#include "kernels.h"

namespace repro {
cudaError_t launch_waterfill(const WaterfillArgs&, cudaStream_t) {
  return cudaErrorNotSupported;
}
}  // namespace repro
