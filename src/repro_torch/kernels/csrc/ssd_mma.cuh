// Fragment helpers of the SSD scan's tensor-core products, shared by the
// forward (ssd_scan.cu) and the backward (ssd_scan_bwd.cu): f32 operands as
// split TF32 (mma.cuh), an operand that is a bf16 input kept exact (its lo
// terms left out), one A against several B tiles with the products
// interleaved, and one 16 x 8 tile of A B^T over two row-major f32 tiles in
// shared memory (C B^T in both kernels).
//
// mma.cuh is included with <> so that a build that puts a stand-in first on
// the include path (the host emulation, tests/host_cuda) gets the stand-in
// here too.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <mma.cuh>

namespace repro {
namespace {

// An A fragment of four f32 values as TF32 (hi, lo); an exact operand (a
// bf16 input) is its own hi and has no lo.
template <bool kExact>
__device__ __forceinline__ void split_frag(float v0, float v1, float v2,
                                           float v3, uint32_t* hi,
                                           uint32_t* lo) {
  if constexpr (kExact) {
    hi[0] = __float_as_uint(v0);
    hi[1] = __float_as_uint(v1);
    hi[2] = __float_as_uint(v2);
    hi[3] = __float_as_uint(v3);
  } else {
    split_tf32(v0, hi[0], lo[0]);
    split_tf32(v1, hi[1], lo[1]);
    split_tf32(v2, hi[2], lo[2]);
    split_tf32(v3, hi[3], lo[3]);
  }
}

// c += A B, A as TF32 (hi, lo) and B as the two f32 values of a lane's
// fragment; the lo terms of an exact operand are left out.
template <bool kExactA, bool kExactB>
__device__ __forceinline__ void mma_f32(float* c, const uint32_t* ah,
                                        const uint32_t* al, float b0,
                                        float b1) {
  if constexpr (kExactB) {
    const uint32_t h0 = __float_as_uint(b0), h1 = __float_as_uint(b1);
    if constexpr (!kExactA) mma_tf32(c, al, h0, h1);
    mma_tf32(c, ah, h0, h1);
  } else {
    uint32_t bh0, bl0, bh1, bl1;
    split_tf32(b0, bh0, bl0);
    split_tf32(b1, bh1, bl1);
    if constexpr (kExactA) {
      mma_tf32(c, ah, bl0, bl1);
      mma_tf32(c, ah, bh0, bh1);
    } else {
      mma_split(c, ah, al, bh0, bh1, bl0, bl1);
    }
  }
}

// c[i] += A B_i for the NT tiles i whose bit is set in `valid`, A as TF32
// (hi, lo) and B_i as the two f32 values b0[i], b1[i] of a lane's
// fragment: each accumulator gets mma_f32's three products in its order,
// issued a term at a time across the tiles, so that independent products
// are in flight together instead of each waiting on the one before.
template <bool kExactA, bool kExactB, int NT>
__device__ __forceinline__ void mma_tiles(float (*c)[4], const uint32_t* ah,
                                          const uint32_t* al,
                                          const float* b0, const float* b1,
                                          unsigned valid) {
  uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    if constexpr (kExactB) {
      bh[i][0] = __float_as_uint(b0[i]);
      bh[i][1] = __float_as_uint(b1[i]);
    } else {
      split_tf32(b0[i], bh[i][0], bl[i][0]);
      split_tf32(b1[i], bh[i][1], bl[i][1]);
    }
  }
  if constexpr (!kExactA) {
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      if (valid >> i & 1) mma_tf32(c[i], al, bh[i][0], bh[i][1]);
    }
  }
  if constexpr (!kExactB) {
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      if (valid >> i & 1) mma_tf32(c[i], ah, bl[i][0], bl[i][1]);
    }
  }
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    if (valid >> i & 1) mma_tf32(c[i], ah, bh[i][0], bh[i][1]);
  }
}

// acc (16 x 8) += C rows (cr, 16 of them) . B rows (br, 8 of them)^T over
// np columns
template <bool kBf16>
__device__ __forceinline__ void cb_tile(float* acc, const float* cr,
                                        const float* br, int fs, int np,
                                        int g, int t) {
  if constexpr (kBf16) {
    // both operands exact in bf16: m16n8k16 with f32 accumulators
    for (int k0 = 0; k0 < np; k0 += 16) {
      const float* ap = cr + g * fs + k0 + 2 * t;
      const float2 a00 = *reinterpret_cast<const float2*>(ap);
      const float2 a10 = *reinterpret_cast<const float2*>(ap + 8 * fs);
      const float2 a01 = *reinterpret_cast<const float2*>(ap + 8);
      const float2 a11 = *reinterpret_cast<const float2*>(ap + 8 * fs + 8);
      const uint32_t af[4] = {pack_f32(a00.x, a00.y), pack_f32(a10.x, a10.y),
                              pack_f32(a01.x, a01.y), pack_f32(a11.x, a11.y)};
      const float* bp = br + g * fs + k0 + 2 * t;
      const float2 b0 = *reinterpret_cast<const float2*>(bp);
      const float2 b1 = *reinterpret_cast<const float2*>(bp + 8);
      mma_bf16(acc, af, pack_f32(b0.x, b0.y), pack_f32(b1.x, b1.y));
    }
  } else {
    for (int k0 = 0; k0 < np; k0 += 16) {
      const float4 q0 = *reinterpret_cast<const float4*>(cr + g * fs + k0 + 4 * t);
      const float4 q1 =
          *reinterpret_cast<const float4*>(cr + (g + 8) * fs + k0 + 4 * t);
      const float4 kv = *reinterpret_cast<const float4*>(br + g * fs + k0 + 4 * t);
      uint32_t ah[2][4], al[2][4];
      split_frag<false>(q0.x, q1.x, q0.y, q1.y, ah[0], al[0]);
      split_frag<false>(q0.z, q1.z, q0.w, q1.w, ah[1], al[1]);
      mma_f32<false, false>(acc, ah[0], al[0], kv.x, kv.y);
      mma_f32<false, false>(acc, ah[1], al[1], kv.z, kv.w);
    }
  }
}

}  // namespace
}  // namespace repro
