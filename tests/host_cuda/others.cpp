// The LLM kernels' launchers, which bindings.cpp names, but RMSNorm's:
// refused under the host emulation, which runs one kernel's source at a
// time (each test links it and the others' stubs: no_schedule_tick.cpp,
// no_waterfill.cpp, no_rmsnorm.cpp, no_rmsnorm_bwd.cpp).
// repro_emu_config sets how the emulation runs the next launches.
#include "kernels.h"

namespace repro {
cudaError_t launch_flash_attention(const AttnArgs&, int, cudaStream_t) {
  return cudaErrorNotSupported;
}
cudaError_t launch_flash_attention_bwd(const AttnBwdArgs&, int,
                                       cudaStream_t) {
  return cudaErrorNotSupported;
}
cudaError_t launch_ssd_scan(const SsdArgs&, int, cudaStream_t) {
  return cudaErrorNotSupported;
}
}  // namespace repro

extern "C" void repro_emu_config(int all_at_once, int release_delay_us,
                                 double time_limit_s) {
  emu::config.all_at_once = all_at_once != 0;
  emu::config.release_delay_us = release_delay_us;
  emu::config.time_limit_s = time_limit_s;
}
