// Host emulation of the CUDA subset that csrc/schedule_tick.cu uses, so
// tests/test_torch_tick_host.py can run the kernel's own source on a CPU:
// every CUDA thread is a std::thread, and warps, CTAs and clusters
// synchronise through std::barrier (C++20).  Warp shuffles and reductions
// exchange values through the warp's array between two barrier phases; a
// cluster's CTAs run together, and map_shared_rank() points into a sibling
// CTA's dynamic shared memory.  It checks the kernel's logic (indices,
// reductions, scans, barrier counts), not its speed or the GPU's memory
// model.  The test rewrites the kernel's `extern __shared__` array into
// emu::dynamic_smem().
#pragma once
#include <math.h>

#include <barrier>
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
struct int4 {
  int x, y, z, w;
};
inline int3 make_int3(int a, int b, int c) { return {a, b, c}; }
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
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

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorNotSupported = 801 };
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

namespace emu {
struct Warp {
  std::barrier<> bar{32};
  long long vals[32];
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
// every lane posts its value; the second phase keeps a lane from posting
// the next value before all have read this one
inline void post(long long v) {
  cur.warp->vals[cur.lane] = v;
  cur.warp->bar.arrive_and_wait();
}
inline long long read(int lane) { return cur.warp->vals[lane & 31]; }
inline void done() { cur.warp->bar.arrive_and_wait(); }
}  // namespace emu

inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

inline void __syncthreads() { emu::cur.block->bar->arrive_and_wait(); }

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

// Runs the grid one cluster at a time, each CTA thread a std::thread.
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
  for (unsigned first = 0; first < grid; first += c) {
    emu::Cluster cl;
    cl.bar = std::make_unique<std::barrier<>>(c * nt);
    std::vector<std::unique_ptr<emu::Block>> blocks;
    for (unsigned r = 0; r < c; ++r) {
      auto b = std::make_unique<emu::Block>();
      b->bar = std::make_unique<std::barrier<>>(nt);
      b->smem.assign(cfg->dynamicSmemBytes + 16, 0xcd);  // not zeroed
      for (unsigned w = 0; w < nt / 32; ++w)
        b->warps.push_back(std::make_unique<emu::Warp>());
      cl.blocks.push_back(b.get());
      blocks.push_back(std::move(b));
    }
    std::vector<std::thread> threads;
    for (unsigned r = 0; r < c; ++r)
      for (unsigned t = 0; t < nt; ++t)
        threads.emplace_back([&, r, t] {
          threadIdx = dim3(t);
          blockIdx = dim3(first + r);
          blockDim = dim3(nt);
          gridDim = dim3(grid);
          emu::cur = {cl.blocks[r], &cl, r, cl.blocks[r]->warps[t / 32].get(),
                      static_cast<int>(t % 32)};
          kernel(args...);
        });
    for (auto& th : threads) th.join();
  }
  return cudaSuccess;
}
