// Tensor-core helpers shared by the kernels that run their products as
// mma.sync (flash_attention*.cu, ssd_scan*.cu), cp.async copies into shared
// memory, and the shared-memory opt-in.  The host emulation of CUDA
// (tests/host_cuda/mma.cuh) stands in for this file, with the same fragment
// layouts.
//
// f32 products run as split TF32: x = hi + lo with both parts TF32, and
// a * b as hi*hi + hi*lo + lo*hi (three m16n8k8 TF32 products), which keeps
// close to f32 accuracy at a third of the TF32 rate.  An operand that is
// exactly TF32 already (a bf16 value widened to f32) has lo = 0, and its
// lo terms can be left out.  bf16 products run as m16n8k16 with f32
// accumulators.
//
// Fragment layouts (PTX ISA, g = lane / 4, t = lane % 4):
//   m16n8k8 tf32   A: a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//                  B: b0 (k=t, n=g)  b1 (k=t+4, n=g)
//   m16n8k16 bf16  A: a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)
//                     a3 (g+8, 2t+8..);  B: b0 (k=2t.., n=g)  b1 (k=2t+8..)
//   accumulator    c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// Rounds x to TF32 (to nearest, ties away from zero: what
// cvt.rna.tf32.f32 gives for finite x) in two full-rate integer ops.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// hi*hi + hi*lo + lo*hi, the small terms first
__device__ __forceinline__ void mma_split(float* c, const uint32_t* ah,
                                          const uint32_t* al, uint32_t bh0,
                                          uint32_t bh1, uint32_t bl0,
                                          uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 values in one register, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 bytes from device to shared memory, in flight until the group that
// holds it is waited for (cp_async_commit closes a group; cp_async_wait<N>
// waits until at most N groups are in flight)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Lets `Kernel` take `smem` bytes of dynamic shared memory.  The opt-in is
// a driver call, so it is made once per kernel and device for the most
// bytes asked so far.
constexpr int kMaxDevices = 64;

template <auto Kernel>
cudaError_t allow_smem(size_t smem) {
  static size_t allowed[kMaxDevices] = {};
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = smem;
  return err;
}

}  // namespace repro
