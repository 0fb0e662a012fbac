// The other kernels' launchers, which bindings.cpp names: refused under the
// host emulation, which runs schedule_tick.cu alone.
#include "kernels.h"

namespace repro {
cudaError_t launch_waterfill(const int*, const int*, int*, int, int,
                             cudaStream_t) {
  return cudaErrorNotSupported;
}
cudaError_t launch_rmsnorm(const NormArgs&, cudaStream_t) {
  return cudaErrorNotSupported;
}
cudaError_t launch_flash_attention(const AttnArgs&, int, cudaStream_t) {
  return cudaErrorNotSupported;
}
cudaError_t launch_ssd_scan(const SsdArgs&, int, cudaStream_t) {
  return cudaErrorNotSupported;
}
}  // namespace repro
