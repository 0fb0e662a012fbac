// Stands in for csrc/atomics.cuh under the host emulation: the same acquire
// loads and release stores through std::atomic_ref.  A release store first
// waits emu::config.release_delay_us (it widens the races a test wants to
// see); an acquire load past the launch's time limit reads all ones, which
// ends any spin-wait on it.
#pragma once
#include "cuda_runtime.h"

namespace repro {
inline unsigned long long load_acquire(const unsigned long long* p) {
  if (emu::past_deadline()) return ~0ull;
  std::this_thread::yield();  // let the threads that would publish run
  return std::atomic_ref<unsigned long long>(
             *const_cast<unsigned long long*>(p))
      .load(std::memory_order_acquire);
}
inline void store_release(unsigned long long* p, unsigned long long v) {
  if (emu::config.release_delay_us > 0)
    std::this_thread::sleep_for(
        std::chrono::microseconds(emu::config.release_delay_us));
  std::atomic_ref<unsigned long long>(*p).store(v, std::memory_order_release);
}
}  // namespace repro
