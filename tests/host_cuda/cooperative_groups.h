// The thread block cluster part of cooperative_groups under the host
// emulation (cuda_runtime.h beside it).
#pragma once
#include "cuda_runtime.h"

namespace cooperative_groups {
struct cluster_group {
  unsigned block_rank() const { return emu::cur.rank; }
  unsigned num_blocks() const {
    return static_cast<unsigned>(emu::cur.cluster->blocks.size());
  }
  void sync() const { emu::cur.cluster->bar->arrive_and_wait(); }
  // the same offset in CTA `rank`'s dynamic shared memory
  template <class T>
  T* map_shared_rank(T* p, unsigned rank) const {
    unsigned char* mine = emu::cur.block->smem.data();
    const std::ptrdiff_t off = reinterpret_cast<unsigned char*>(p) - mine;
    assert(off >= 0 &&
           off < static_cast<std::ptrdiff_t>(emu::cur.block->smem.size()));
    assert(rank < emu::cur.cluster->blocks.size());
    return reinterpret_cast<T*>(emu::cur.cluster->blocks[rank]->smem.data() +
                                off);
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
