// The LLM kernels' launchers, which bindings.cpp names, but RMSNorm's:
// refused under the host emulation, which runs one kernel's source at a
// time (each test links it and the others' stubs: no_schedule_tick.cpp,
// no_waterfill.cpp, no_rmsnorm.cpp, no_rmsnorm_bwd.cpp).  The SSD scan's
// backward is stubbed unless REPRO_EMU_SSD_SCAN_BWD is defined: its own
// host build (tests/test_torch_ssd_bwd_host.py) links ssd_scan_bwd.cu.
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
#ifndef REPRO_EMU_SSD_SCAN_BWD
cudaError_t launch_ssd_scan_bwd(const SsdBwdArgs&, int, cudaStream_t) {
  return cudaErrorNotSupported;
}
#endif
}  // namespace repro

extern "C" void repro_emu_config(int all_at_once, int release_delay_us,
                                 double time_limit_s) {
  emu::config.all_at_once = all_at_once != 0;
  emu::config.release_delay_us = release_delay_us;
  emu::config.time_limit_s = time_limit_s;
}
