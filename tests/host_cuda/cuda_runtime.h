// Host emulation of the CUDA subset that csrc/schedule_tick.cu,
// csrc/waterfill.cu, csrc/rmsnorm_bwd.cu and csrc/ssd_scan_bwd.cu use, so
// tests/test_torch_{tick,waterfill,rmsnorm,ssd_bwd}_host.py can run the
// kernels' own source on a CPU: every CUDA thread of a step is a
// std::thread, and warps, CTAs and clusters synchronise through
// std::barrier (C++20).  Warp shuffles, votes, reductions and the
// tensor-core products (mma.cuh beside it) exchange values through the
// warp's arrays between two barrier phases; a cluster's CTAs run together,
// and map_shared_rank() points into a sibling CTA's dynamic shared memory.
// Atomics go through std::atomic_ref.  The grid runs one cluster at a time
// in blockIdx order, or (emu::config, from the test) every CTA at once,
// released together (up to emu::kMaxThreadsAtOnce threads a step).  An
// acquire load that spins past the launch's time
// limit reads all ones from then on and the launch returns
// cudaErrorLaunchTimeout, so a wait that can never end fails the test
// instead of hanging it.  It checks the kernels' logic (indices,
// reductions, scans, barrier counts), not their speed or the GPU's memory
// model.  The tests rewrite a kernel's `extern __shared__` array into
// emu::dynamic_smem().
#pragma once
#include <math.h>

#include <algorithm>
#include <atomic>
#include <barrier>
#include <chrono>
#include <cassert>
#include <climits>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
#define __shared__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct int3 {
  int x, y, z;
};
struct float2 {
  float x, y;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
struct uint2 {
  unsigned x, y;
};
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
struct int4 {
  int x, y, z, w;
};
inline int3 make_int3(int a, int b, int c) { return {a, b, c}; }
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
template <class T>
T __ldcg(const T* p) {
  return *p;
}
inline int __float_as_int(float f) {
  int i;
  std::memcpy(&i, &f, 4);
  return i;
}
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, 4);
  return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorLaunchTimeout = 702, cudaErrorNotSupported = 801 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttributeValue {
  struct {
    unsigned x, y, z;
  } clusterDim;
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline const char* cudaGetErrorString(cudaError_t e) {
  return e == cudaSuccess ? "no error" : "refused by the host emulation";
}
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return cudaSuccess;
}

namespace emu {
// A warp's exchanges (shuffles, votes, reductions; the tensor-core
// products of mma.cuh) each take one barrier phase: every lane posts into
// one of two buffers, taken in turn by the lane's count of exchanges, and
// posts into it again two exchanges later, once every lane has passed the
// barrier of the exchange between, so has read it.
struct Warp {
  std::barrier<> bar{32};
  long long vals[2][32];
  unsigned posts[32];
  unsigned frag[2][32][12];   // a product's registers, each lane's
  unsigned products[32];
};
struct Block {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<unsigned char> smem;
  std::vector<std::unique_ptr<Warp>> warps;
};
struct Cluster {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<Block*> blocks;
};
struct Thread {
  Block* block;
  Cluster* cluster;
  unsigned rank;
  Warp* warp;
  int lane;
};
inline thread_local Thread cur;

// The most threads a launch "all at once" starts together (a grid of more
// runs in steps of whole clusters, in blockIdx order): a host makes only so
// many threads.
constexpr unsigned kMaxThreadsAtOnce = 8192;
// Set by the test between launches (others.cpp: repro_emu_config).
struct Config {
  bool all_at_once = false;   // run every CTA of the grid together
  int release_delay_us = 0;   // a release store waits this long first
  double time_limit_s = 60.0;  // of a launch's spin-waits
};
inline Config config;
inline std::chrono::steady_clock::time_point deadline;
inline std::atomic<bool> timed_out{false};
// true once the launch is past its time limit (a spinning load gives up)
inline bool past_deadline() {
  if (std::chrono::steady_clock::now() > deadline) timed_out = true;
  return timed_out;
}

inline unsigned char* dynamic_smem() { return cur.block->smem.data(); }

template <class T>
long long bits(T v) {
  long long b = 0;
  std::memcpy(&b, &v, sizeof(T));
  return b;
}
template <class T>
T unbits(long long b) {
  T v;
  std::memcpy(&v, &b, sizeof(T));
  return v;
}
// every lane posts its value, then reads any lane's (Warp: one phase)
inline void post(long long v) {
  Warp* w = cur.warp;
  w->vals[w->posts[cur.lane]++ & 1][cur.lane] = v;
  w->bar.arrive_and_wait();
}
inline long long read(int lane) {
  Warp* w = cur.warp;
  return w->vals[(w->posts[cur.lane] - 1) & 1][lane & 31];
}
inline void done() {}
}  // namespace emu

inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

inline void __syncthreads() { emu::cur.block->bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu::cur.warp->bar.arrive_and_wait();
}

template <class T>
T __shfl_sync(unsigned, T v, int src) {
  emu::post(emu::bits(v));
  const T r = emu::unbits<T>(emu::read(src));
  emu::done();
  return r;
}
template <class T>
T __shfl_up_sync(unsigned, T v, unsigned d) {
  emu::post(emu::bits(v));
  const int src = emu::cur.lane - static_cast<int>(d);
  const T r = src < 0 ? v : emu::unbits<T>(emu::read(src));
  emu::done();
  return r;
}
template <class T>
T __shfl_down_sync(unsigned, T v, unsigned d) {
  emu::post(emu::bits(v));
  const int src = emu::cur.lane + static_cast<int>(d);
  const T r = src > 31 ? v : emu::unbits<T>(emu::read(src));
  emu::done();
  return r;
}
template <class T>
T __shfl_xor_sync(unsigned, T v, int mask) {
  emu::post(emu::bits(v));
  const T r = emu::unbits<T>(emu::read(emu::cur.lane ^ mask));
  emu::done();
  return r;
}

template <class Op>
int warp_reduce(int v, Op op) {
  emu::post(v);
  int r = static_cast<int>(emu::read(0));
  for (int l = 1; l < 32; ++l) r = op(r, static_cast<int>(emu::read(l)));
  emu::done();
  return r;
}
inline unsigned __ballot_sync(unsigned, bool pred) {
  emu::post(pred ? 1 : 0);
  unsigned r = 0;
  for (int l = 0; l < 32; ++l) r |= static_cast<unsigned>(emu::read(l)) << l;
  emu::done();
  return r;
}
inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).fetch_add(v);
}
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}

inline int __reduce_add_sync(unsigned, int v) {
  return warp_reduce(v, [](int a, int b) {
    return static_cast<int>(static_cast<unsigned>(a) +
                            static_cast<unsigned>(b));
  });
}
inline int __reduce_max_sync(unsigned, int v) {
  return warp_reduce(v, [](int a, int b) { return a > b ? a : b; });
}
inline int __reduce_min_sync(unsigned, int v) {
  return warp_reduce(v, [](int a, int b) { return a < b ? a : b; });
}

// Runs the grid one cluster at a time (or all at once, emu::config), each
// CTA thread of a step a std::thread.
template <class... Exp, class... Act>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                               void (*kernel)(Exp...), Act&&... args) {
  unsigned c = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension)
      c = cfg->attrs[i].val.clusterDim.x;
  const unsigned grid = cfg->gridDim.x, nt = cfg->blockDim.x;
  if (c < 1 || c > 8 || grid % c || nt % 32 || nt == 0 || nt > 1024 ||
      cfg->dynamicSmemBytes > 232448)
    return cudaErrorInvalidValue;
  emu::timed_out = false;
  using Clock = std::chrono::steady_clock;
  emu::deadline = Clock::now() + std::chrono::duration_cast<Clock::duration>(
                                     std::chrono::duration<double>(
                                         emu::config.time_limit_s));
  // all at once: up to kMaxThreadsAtOnce threads' worth of whole clusters
  // a step, in blockIdx order
  const unsigned wide = std::max(c, emu::kMaxThreadsAtOnce / nt / c * c);
  const unsigned most = emu::config.all_at_once ? std::min(grid, wide) : c;
  std::vector<std::unique_ptr<emu::Cluster>> clusters;
  std::vector<std::unique_ptr<emu::Block>> blocks;
  for (unsigned b = 0; b < grid; ++b) {
    if (b % c == 0) {
      clusters.push_back(std::make_unique<emu::Cluster>());
      clusters.back()->bar = std::make_unique<std::barrier<>>(c * nt);
    }
    auto blk = std::make_unique<emu::Block>();
    blk->bar = std::make_unique<std::barrier<>>(nt);
    blk->smem.assign(cfg->dynamicSmemBytes + 16, 0xcd);  // not zeroed
    for (unsigned w = 0; w < nt / 32; ++w)
      blk->warps.push_back(std::make_unique<emu::Warp>());
    clusters.back()->blocks.push_back(blk.get());
    blocks.push_back(std::move(blk));
  }
  // a thread for each CTA thread of a step, reused step after step (a
  // grid of thousands of CTAs would otherwise start millions of threads)
  const unsigned pool = most * nt;
  std::barrier<> gate(static_cast<std::ptrdiff_t>(pool));
  std::vector<std::thread> threads;
  for (unsigned s = 0; s < pool; ++s)
    threads.emplace_back([&, s] {
      const unsigned t = s % nt;
      for (unsigned first = 0; first < grid; first += most) {
        gate.arrive_and_wait();  // every thread of the step starts at once
        const unsigned b = first + s / nt;
        if (b >= grid) continue;
        emu::Cluster* cl = clusters[b / c].get();
        threadIdx = dim3(t);
        blockIdx = dim3(b);
        blockDim = dim3(nt);
        gridDim = dim3(grid);
        emu::cur = {cl->blocks[b % c], cl, b % c,
                    cl->blocks[b % c]->warps[t / 32].get(),
                    static_cast<int>(t % 32)};
        kernel(args...);
      }
    });
  for (auto& th : threads) th.join();
  return emu::timed_out ? cudaErrorLaunchTimeout : cudaSuccess;
}
