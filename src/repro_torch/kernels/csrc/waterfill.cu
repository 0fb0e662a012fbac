// Prefix waterfill for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/waterfill.py::_waterfill_kernel
// (wrapper waterfill; callers greedy_{shrink,expand}_pallas and
// repro/core/passes.py::_pallas_give): per row,
//   take[i] = clip(target - exclusive_prefix_sum(cap)[i], 0, cap[i]),
// whose sum is min(target, sum(cap)).  With `order` (a permutation of each
// row: argsort's output) slot i reads cap[order[i]] and writes its take to
// out[order[i]], which is the whole greedy give of _pallas_give (gather,
// waterfill, scatter) in one launch.  Sums run in unsigned: exact modulo
// 2^32 in any order, as the plain version's int32 sums are, so every tier is
// bit-equal to it.
//
// Bound on this card: bytes -- 8 a slot (read cap, write take; 16 with an
// int64 order) and 4 a row (the target) at 3.35 TB/s, which is 0.34 us for
// a 143,829-slot row and 10 ns for theta's 31 x 128.  Every call the engine
// makes moves far less than a microsecond of traffic, so the time is
// latency: the launch, one load of the row, and the steps that join partial
// sums.  The TPU kernel walks 2,048-slot blocks in order with the running
// sum in SMEM; Hopper's CTAs run in no order, so the tiers
// (kernels/waterfill.py::plan picks one from the shape) join the partial
// sums in as few dependent steps as the row allows:
//   warp -- rows of up to 256 slots: one warp a row (several rows a CTA once
//     the rows outnumber the SMs).  Each lane holds k = N / 32 consecutive
//     slots in registers and scans them serially; one shuffle scan joins
//     the lanes.  No barrier.
//   cta -- rows of up to 4,096 slots: one CTA a row, 4 consecutive slots a
//     thread loaded once, one block scan (a shuffle scan in each warp, the
//     warp totals scanned by one warp; two barriers).  On the H100 this
//     beat the look-back at these lengths even for 8 rows on 132 SMs.
//   lookback -- longer rows: each row is cut into tiles of threads * k slots,
//     one CTA a tile, joined by a single-pass decoupled look-back scan
//     (Merrill & Garland, "Single-pass Parallel Prefix Scan with Decoupled
//     Look-back", NVIDIA 2016).  A CTA takes its tile from an atomic
//     counter, so every tile it waits on is already running and publishes
//     without waiting (no deadlock).  A tile publishes its aggregate, then
//     its inclusive prefix, as one 64-bit word (flag << 32 | value) with a
//     release store; one warp reads up to 32 predecessors at once with
//     acquire loads.  The counter and descriptors live in a scratch the
//     wrapper allocates and the launch clears with a memset it issues
//     itself, so a CUDA-graph replay starts clean.  Its floor (the memset,
//     the counter, the descriptor round trips) is several microseconds
//     (PERF.md section 6), which is why shorter rows take the CTA tier.
// Loads and stores are 16 bytes a thread where the row's alignment allows
// (the plan's `vec`), else 4; with `order` the gather and scatter are 4.
#include "atomics.cuh"
#include "block.cuh"
#include "kernels.h"

namespace repro {
namespace {

// look-back descriptor flags (the word's high half)
constexpr unsigned kInvalid = 0, kAggregate = 1, kPrefix = 2;
// shared words: 32 warp sums, the CTA sum, the tile, the tile's prefix
constexpr int kShTotal = 32, kShTile = 33, kShPrefix = 34;
constexpr size_t kSmemBytes = 35 * sizeof(unsigned);

__device__ __forceinline__ unsigned long long descriptor(unsigned flag,
                                                         unsigned value) {
  return static_cast<unsigned long long>(flag) << 32 | value;
}

__device__ __forceinline__ int row_target(const WaterfillArgs& a, int row) {
  if (a.target == nullptr) return a.target_value;
  return a.target[a.target_shared ? 0 : row];
}

// Slots [s, s + K) of the row at `off` (0 past N); with order, idx gets the
// row position each one reads and will write.
template <int K>
__device__ __forceinline__ void load_slots(const WaterfillArgs& a, size_t off,
                                           int s, int (&v)[K], int (&idx)[K]) {
  const int n = a.N;
  if (a.order != nullptr) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      idx[j] = s + j < n ? static_cast<int>(a.order[off + s + j]) : 0;
      v[j] = s + j < n ? a.cap[off + idx[j]] : 0;
    }
    return;
  }
  if constexpr (K % 4 == 0) {
    if (a.vec) {
#pragma unroll
      for (int j = 0; j < K; j += 4) {
        const int i = s + j;
        if (i + 4 <= n) {
          const int4 q = *reinterpret_cast<const int4*>(a.cap + off + i);
          v[j] = q.x;
          v[j + 1] = q.y;
          v[j + 2] = q.z;
          v[j + 3] = q.w;
        } else {
#pragma unroll
          for (int t = 0; t < 4; ++t)
            v[j + t] = i + t < n ? a.cap[off + i + t] : 0;
        }
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) v[j] = s + j < n ? a.cap[off + s + j] : 0;
}

template <int K>
__device__ __forceinline__ void store_slots(const WaterfillArgs& a,
                                            size_t off, int s,
                                            const int (&v)[K],
                                            const int (&idx)[K]) {
  const int n = a.N;
  if (a.order != nullptr) {
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (s + j < n) a.out[off + idx[j]] = v[j];
    return;
  }
  if constexpr (K % 4 == 0) {
    if (a.vec) {
#pragma unroll
      for (int j = 0; j < K; j += 4) {
        const int i = s + j;
        if (i + 4 <= n) {
          *reinterpret_cast<int4*>(a.out + off + i) =
              make_int4(v[j], v[j + 1], v[j + 2], v[j + 3]);
        } else {
#pragma unroll
          for (int t = 0; t < 4; ++t)
            if (i + t < n) a.out[off + i + t] = v[j + t];
        }
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j)
    if (s + j < n) a.out[off + s + j] = v[j];
}

template <int K>
__device__ __forceinline__ unsigned slot_sum(const int (&v)[K]) {
  unsigned t = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) t += static_cast<unsigned>(v[j]);
  return t;
}

// Turns each capacity into its take, given `before`, the sum of the row's
// slots ahead of this thread's first.
template <int K>
__device__ __forceinline__ void give(int (&v)[K], unsigned before, int tgt) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int c = v[j];
    const int left = static_cast<int>(static_cast<unsigned>(tgt) - before);
    v[j] = min(max(left, 0), c);
    before += static_cast<unsigned>(c);
  }
}

// Exclusive scan of x over the warp; *total gets the warp's sum.
__device__ __forceinline__ unsigned warp_exclusive(unsigned x,
                                                   unsigned* total) {
  const int lane = threadIdx.x & 31;
  unsigned inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned n = __shfl_up_sync(kFullMask, inc, o);
    if (lane >= o) inc += n;
  }
  *total = __shfl_sync(kFullMask, inc, 31);
  return inc - x;
}

// Exclusive scan of x over the CTA with two barriers (one warp scans the
// warp sums); *total gets the CTA's sum.  Called once a launch.
__device__ __forceinline__ unsigned block_exclusive(unsigned x, unsigned* sh,
                                                    unsigned* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  unsigned wsum;
  const unsigned in_warp = warp_exclusive(x, &wsum);
  if (lane == 0) sh[wid] = wsum;
  __syncthreads();
  if (wid == 0) {
    unsigned all;
    const unsigned e = warp_exclusive(lane < nw ? sh[lane] : 0u, &all);
    if (lane < nw) sh[lane] = e;
    if (lane == 0) sh[kShTotal] = all;
  }
  __syncthreads();
  *total = sh[kShTotal];
  return sh[wid] + in_warp;
}

// The sum of the row's tiles before `tile`, whose descriptor is at `mine`:
// warp-wide, lane l reads the descriptor l + 1 tiles back, waiting until it
// holds at least an aggregate; the lanes up to the nearest inclusive prefix
// are summed, or all 32 and the window moves 32 tiles back.
__device__ unsigned look_back(const unsigned long long* mine, int tile) {
  const int lane = threadIdx.x & 31;
  unsigned excl = 0;
  for (int back = 1;; back += 32) {
    // before the row's first tile nothing is left to add
    unsigned long long d = descriptor(kPrefix, 0);
    if (tile - back - lane >= 0) {
      do {
        d = load_acquire(mine - back - lane);
      } while ((d >> 32) == kInvalid);
    }
    const unsigned ready = __ballot_sync(kFullMask, (d >> 32) == kPrefix);
    const int last = ready ? __ffs(ready) - 1 : 31;
    unsigned sum = lane <= last ? static_cast<unsigned>(d) : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFullMask, sum, o);
    excl += sum;
    if (ready) return excl;
  }
}

template <int K>
__global__ void waterfill_warp(const WaterfillArgs a) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= a.B) return;  // the whole warp
  const size_t off = static_cast<size_t>(row) * a.N;
  const int s = (threadIdx.x & 31) * K;
  int v[K], idx[K];
  load_slots<K>(a, off, s, v, idx);
  unsigned all;
  const unsigned before = warp_exclusive(slot_sum<K>(v), &all);
  give<K>(v, before, row_target(a, row));
  store_slots<K>(a, off, s, v, idx);
}

template <int K>
__global__ void waterfill_cta(const WaterfillArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* sh = reinterpret_cast<unsigned*>(smem);
  const int row = blockIdx.x;
  const size_t off = static_cast<size_t>(row) * a.N;
  const int s = threadIdx.x * K;
  int v[K], idx[K];
  load_slots<K>(a, off, s, v, idx);
  unsigned all;
  const unsigned before = block_exclusive(slot_sum<K>(v), sh, &all);
  give<K>(v, before, row_target(a, row));
  store_slots<K>(a, off, s, v, idx);
}

template <int K>
__global__ void waterfill_lookback(const WaterfillArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* sh = reinterpret_cast<unsigned*>(smem);
  const int tile_slots = blockDim.x * K;
  const int tiles = (a.N + tile_slots - 1) / tile_slots;
  if (threadIdx.x == 0)
    sh[kShTile] = atomicAdd(reinterpret_cast<unsigned*>(a.scratch), 1u);
  __syncthreads();
  const unsigned id = sh[kShTile];
  const int row = id / tiles, tile = id % tiles;
  const size_t off = static_cast<size_t>(row) * a.N;
  const int s = tile * tile_slots + threadIdx.x * K;
  int v[K], idx[K];
  load_slots<K>(a, off, s, v, idx);
  unsigned agg;
  const unsigned in_tile = block_exclusive(slot_sum<K>(v), sh, &agg);
  if (threadIdx.x < 32) {
    unsigned long long* mine = a.scratch + 1 + id;
    unsigned excl = 0;
    if (tile == 0) {
      if (threadIdx.x == 0) store_release(mine, descriptor(kPrefix, agg));
    } else {
      if (threadIdx.x == 0) store_release(mine, descriptor(kAggregate, agg));
      excl = look_back(mine, tile);
      if (threadIdx.x == 0)
        store_release(mine, descriptor(kPrefix, excl + agg));
    }
    if (threadIdx.x == 0) sh[kShPrefix] = excl;
  }
  __syncthreads();
  give<K>(v, sh[kShPrefix] + in_tile, row_target(a, row));
  store_slots<K>(a, off, s, v, idx);
}

using KernelFn = void (*)(WaterfillArgs);

cudaError_t launch_kernel(KernelFn kernel, const WaterfillArgs& a,
                          long long grid,
                          cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid), 1, 1);
  cfg.blockDim = dim3(a.threads, 1, 1);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cfg.attrs = nullptr;
  cfg.numAttrs = 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The tier's kernel for k slots a thread, or null for a k it has no
// instantiation of.
KernelFn warp_kernel(int k) {
  switch (k) {
    case 1: return waterfill_warp<1>;
    case 2: return waterfill_warp<2>;
    case 4: return waterfill_warp<4>;
    case 8: return waterfill_warp<8>;
    case 16: return waterfill_warp<16>;
    case 32: return waterfill_warp<32>;
    default: return nullptr;
  }
}

KernelFn cta_kernel(int tier, int k) {
  const bool lb = tier == kWaterfillLookback;
  switch (k) {
    case 4: return lb ? waterfill_lookback<4> : waterfill_cta<4>;
    case 8: return lb ? waterfill_lookback<8> : waterfill_cta<8>;
    case 16: return lb ? waterfill_lookback<16> : waterfill_cta<16>;
    default: return nullptr;
  }
}

}  // namespace

cudaError_t launch_waterfill(const WaterfillArgs& a, cudaStream_t stream) {
  if (a.B <= 0 || a.N <= 0) return cudaSuccess;
  // the plan must own every slot exactly once and fit the card
  const long long threads = a.threads, k = a.k;
  const long long span = threads * k;
  if (threads < 32 || threads > 1024 || threads % 32 != 0 || k < 1)
    return cudaErrorInvalidValue;
  const auto addr = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p);
  };
  if (a.vec && (a.order != nullptr || k % 4 != 0 ||
                (a.B > 1 && a.N % 4 != 0) ||
                (addr(a.cap) | addr(a.out)) % 16 != 0))
    return cudaErrorInvalidValue;
  switch (a.tier) {
    case kWaterfillWarp: {
      const KernelFn kernel = warp_kernel(a.k);
      if (kernel == nullptr || 32 * k < a.N || a.scratch != nullptr)
        return cudaErrorInvalidValue;
      const long long rows = threads / 32;
      return launch_kernel(kernel, a, (a.B + rows - 1) / rows, stream);
    }
    case kWaterfillCta: {
      const KernelFn kernel = cta_kernel(a.tier, a.k);
      if (kernel == nullptr || span < a.N || a.scratch != nullptr)
        return cudaErrorInvalidValue;
      return launch_kernel(kernel, a, a.B, stream);
    }
    case kWaterfillLookback: {
      const KernelFn kernel = cta_kernel(a.tier, a.k);
      const long long grid = a.B * ((a.N + span - 1) / span);
      if (kernel == nullptr || a.scratch == nullptr || grid > 0x7fffffffLL)
        return cudaErrorInvalidValue;
      // the tile counter and every descriptor start at 0 in every launch
      cudaError_t err = cudaMemsetAsync(
          a.scratch, 0, (1 + grid) * sizeof(unsigned long long), stream);
      if (err != cudaSuccess) return err;
      return launch_kernel(kernel, a, grid, stream);
    }
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace repro
