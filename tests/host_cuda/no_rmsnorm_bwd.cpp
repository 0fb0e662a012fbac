// The RMSNorm backward's launcher, which bindings.cpp names, refused: the
// grid kernels' host builds (tests/test_torch_{tick,waterfill}_host.py) run
// without it.
#include "kernels.h"

namespace repro {
cudaError_t launch_rmsnorm_bwd(const NormBwdArgs&, cudaStream_t) {
  return cudaErrorNotSupported;
}
}  // namespace repro
