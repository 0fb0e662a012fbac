// Stands in for csrc/mma.cuh under the host emulation (cuda_runtime.h
// beside it).  A tensor-core product is one warp's: every lane posts its A
// and B registers to the warp's array, as the shuffles post their values,
// and after a barrier phase each lane computes its own accumulator
// elements from all lanes' registers, read by the fragment layouts of
// csrc/mma.cuh's table (PTX ISA, g = lane / 4, t = lane % 4):
//   m16n8k8 tf32   A: a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//                  B: b0 (k=t, n=g)  b1 (k=t+4, n=g)
//   m16n8k16 bf16  A: a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)
//                     a3 (g+8, 2t+8..);  B: b0 (k=2t.., n=g)  b1 (k=2t+8..)
//   accumulator    c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
// A TF32 register is read by its top 19 bits, as the tensor cores read it;
// a bf16 pair holds the lower k in its low half.  Products are exact in
// f32 and added to the accumulator in k order (the card's order and
// rounding may differ: the tests hold results to tolerances).  cp.async
// is a plain copy, complete when it returns.
#pragma once
#include <cstdint>
#include <cstring>

#include "cuda_bf16.h"
#include "cuda_runtime.h"

namespace repro {

inline uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

inline void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

namespace emu_mma {
typedef unsigned Regs[12];

// Every lane posts its n registers of a product; returns the warp's (one
// barrier phase, two buffers taken in turn: cuda_runtime.h's Warp).
inline const Regs* exchange(const uint32_t* regs, int n) {
  emu::Warp* w = emu::cur.warp;
  const int lane = emu::cur.lane;
  Regs* buf = w->frag[w->products[lane]++ & 1];
  std::memcpy(buf[lane], regs, n * sizeof(uint32_t));
  w->bar.arrive_and_wait();
  return buf;
}

inline float tf32(uint32_t r) { return __uint_as_float(r & 0xffffe000u); }
inline float bf16(uint32_t r, int k) {
  return __uint_as_float(k % 2 ? (r & 0xffff0000u) : (r << 16));
}

// c (this lane's accumulator) += A B of an m16n8k8 TF32 product whose A
// registers are f[lane][ai .. ai + 3] and B registers f[lane][bi, bi + 1]
inline void tf32_product(float* c, const Regs* f, int ai, int bi) {
  const int lane = emu::cur.lane, g = lane >> 2, t = lane & 3;
  for (int e = 0; e < 4; ++e) {
    const int r = g + 8 * (e / 2), n = 2 * t + e % 2;
    float s = c[e];
    for (int k = 0; k < 8; ++k) {
      s += tf32(f[(r % 8) * 4 + k % 4][ai + r / 8 + 2 * (k / 4)]) *
           tf32(f[n * 4 + k % 4][bi + k / 4]);
    }
    c[e] = s;
  }
}
}  // namespace emu_mma

inline void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  const uint32_t r[6] = {a[0], a[1], a[2], a[3], b0, b1};
  emu_mma::tf32_product(c, emu_mma::exchange(r, 6), 0, 4);
}

// hi*hi + hi*lo + lo*hi, the small terms first: the three products of
// csrc/mma.cuh's mma_split, from one exchange
inline void mma_split(float* c, const uint32_t* ah, const uint32_t* al,
                      uint32_t bh0, uint32_t bh1, uint32_t bl0,
                      uint32_t bl1) {
  const uint32_t r[12] = {ah[0], ah[1], ah[2], ah[3], al[0], al[1],
                          al[2], al[3], bh0, bh1, bl0, bl1};
  const emu_mma::Regs* f = emu_mma::exchange(r, 12);
  emu_mma::tf32_product(c, f, 4, 8);
  emu_mma::tf32_product(c, f, 0, 10);
  emu_mma::tf32_product(c, f, 0, 8);
}

inline void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  const uint32_t r[6] = {a[0], a[1], a[2], a[3], b0, b1};
  const emu_mma::Regs* f = emu_mma::exchange(r, 6);
  const int lane = emu::cur.lane, g = lane >> 2, t = lane & 3;
  for (int e = 0; e < 4; ++e) {
    const int rr = g + 8 * (e / 2), n = 2 * t + e % 2;
    float s = c[e];
    for (int k = 0; k < 16; ++k) {
      s += emu_mma::bf16(f[(rr % 8) * 4 + (k % 8) / 2][rr / 8 + 2 * (k / 8)],
                         k) *
           emu_mma::bf16(f[n * 4 + (k % 8) / 2][4 + k / 8], k);
    }
    c[e] = s;
  }
}

inline uint32_t ld32(const __nv_bfloat16* p) {
  uint32_t r;
  std::memcpy(&r, p, 4);
  return r;
}

// two bf16 values in one register, `lo` in the low half
inline uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(lo.bits) | static_cast<uint32_t>(hi.bits) << 16;
}
inline uint32_t pack_f32(float lo, float hi) {
  return pack_bf16(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

inline void cp_async16(void* dst, const void* src) {
  std::memcpy(dst, src, 16);
}
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}

template <auto Kernel>
cudaError_t allow_smem(size_t) {
  return cudaSuccess;
}

}  // namespace repro
