// Pieces shared by the attention kernels: flash_attention.cu (the forward)
// and flash_attention_bwd.cu (the backward).  Tiles of 16 rows a warp run
// their products as mma.sync (mma.cuh): qk_tile computes S = A B^T for a
// warp's 16 rows of A against BK rows of B, both rows of shared memory;
// pv_tile adds P V to an accumulator, with P held as the C fragment of a
// qk_tile product.  Rows are copied into shared memory with cp.async
// (load_rows, on mma.cuh's cp_async16) and padded to a multiple of 16
// columns with zeros (zero_pad).  Every kernel that uses them runs
// kThreads threads a CTA.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "dtype.cuh"
#include "mma.cuh"

namespace repro {
namespace {

constexpr int kThreads = 128;       // 4 warps in every variant
constexpr int kBQ = 64;             // prefill: query rows per CTA
constexpr int kMaxD = 256;

__host__ __device__ constexpr int pad16(int d) { return (d + 15) / 16 * 16; }

// Shared-memory row strides in elements, so that a warp's fragment loads
// hit 32 banks: prefill f32 reads Q / K rows 16 bytes a lane (stride = 16
// words mod 32) and V rows 2t, 2t + 1 (stride = 4 mod 8); bf16 reads
// 4-byte pairs.
template <typename T>
__host__ __device__ constexpr int qk_stride(int dp) {
  return sizeof(T) == 4 ? dp + (dp % 32 == 0 ? 16 : 0) : dp + 8;
}
template <typename T>
__host__ __device__ constexpr int v_stride(int dp) {
  return sizeof(T) == 4 ? dp + 4 : dp + 8;
}

// ------------------------------------------------------------ primitives
// Rows [0, n) of a tile: row j from src + j * src_stride into
// dst + j * dst_stride, D elements each (16-byte cp.async pieces when
// `vec`, else plain element copies); rows [n, rows) are written as zeros.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int dst_stride,
                                          const T* src, long long src_stride,
                                          int n, int rows, int D, bool vec) {
  if (vec) {
    // piece (j, c) steps by kThreads pieces in row-major order, without a
    // division per piece
    constexpr int E = 16 / sizeof(T);
    const int per_row = D / E;
    const int dj = kThreads / per_row, dc = kThreads - dj * per_row;
    int j = threadIdx.x / per_row;
    int c = threadIdx.x - j * per_row;
    while (j < rows) {
      T* d = dst + j * dst_stride + c * E;
      if (j < n) {
        cp_async16(d, src + j * src_stride + c * E);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      }
      j += dj;
      c += dc;
      if (c >= per_row) {
        c -= per_row;
        ++j;
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * D; i += kThreads) {
      const int j = i / D;
      const int c = i - j * D;
      dst[j * dst_stride + c] = j < n ? src[j * src_stride + c]
                                      : from_f32<T>(0.f);
    }
  }
}

// Columns [D, dp) of `rows` rows, as zeros (the head-dim padding).
template <typename T>
__device__ __forceinline__ void zero_pad(T* dst, int stride, int rows, int D,
                                         int dp) {
  const int w = dp - D;
  for (int i = threadIdx.x; i < rows * w; i += kThreads) {
    const int j = i / w;
    dst[j * stride + D + (i - j * w)] = from_f32<T>(0.f);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------- prefill: S = QK^T
// A warp owns 16 query rows; s[n] is the C fragment of its rows and of
// keys n * 8 .. n * 8 + 7.
//
// f32: the mma's k index may map to any column as long as Q and K agree.
// In each 16-column group lane t takes columns 4t .. 4t+3: 4t and 4t+1 are
// its k = t and t + 4 of the first k-step, 4t+2 and 4t+3 of the second, so
// a row's part is one 16-byte load.
template <int DP, int BK>
__device__ __forceinline__ void qk_tile(float (*s)[4],
                                        const float* qw, const float* kt,
                                        int stride, int dp, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    if (kk * 16 < dp) {
      const int col = kk * 16 + 4 * t;
      uint32_t ah[2][4], al[2][4];
      const float* qr = qw + g * stride + col;
      const float4 q0 = *reinterpret_cast<const float4*>(qr);
      const float4 q1 = *reinterpret_cast<const float4*>(qr + 8 * stride);
      split_tf32(q0.x, ah[0][0], al[0][0]);
      split_tf32(q1.x, ah[0][1], al[0][1]);
      split_tf32(q0.y, ah[0][2], al[0][2]);
      split_tf32(q1.y, ah[0][3], al[0][3]);
      split_tf32(q0.z, ah[1][0], al[1][0]);
      split_tf32(q1.z, ah[1][1], al[1][1]);
      split_tf32(q0.w, ah[1][2], al[1][2]);
      split_tf32(q1.w, ah[1][3], al[1][3]);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const float4 kv =
            *reinterpret_cast<const float4*>(kt + (n * 8 + g) * stride + col);
        uint32_t bh[4], bl[4];
        split_tf32(kv.x, bh[0], bl[0]);
        split_tf32(kv.y, bh[1], bl[1]);
        split_tf32(kv.z, bh[2], bl[2]);
        split_tf32(kv.w, bh[3], bl[3]);
        mma_split(s[n], ah[0], al[0], bh[0], bh[1], bl[0], bl[1]);
        mma_split(s[n], ah[1], al[1], bh[2], bh[3], bl[2], bl[3]);
      }
    }
  }
}

template <int DP, int BK>
__device__ __forceinline__ void qk_tile(float (*s)[4],
                                        const __nv_bfloat16* qw,
                                        const __nv_bfloat16* kt, int stride,
                                        int dp, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    if (kk * 16 < dp) {
      uint32_t a[4];
      const __nv_bfloat16* qa =
          qw + g * stride + kk * 16 + 2 * t;
      a[0] = ld32(qa);
      a[1] = ld32(qa + 8 * stride);
      a[2] = ld32(qa + 8);
      a[3] = ld32(qa + 8 * stride + 8);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const __nv_bfloat16* kb = kt + (n * 8 + g) * stride + kk * 16 + 2 * t;
        const uint32_t b0 = ld32(kb), b1 = ld32(kb + 8);
        mma_bf16(s[n], a, b0, b1);
      }
    }
  }
}

// ------------------------------------------------------- prefill: O += PV
// f32: the k index of each 8-key step maps k = t to key 2t and k = t + 4
// to key 2t + 1, the keys lane t holds in S's C fragment, so P needs no
// shuffle to become the A fragment.
template <int DP, int BK>
__device__ __forceinline__ void pv_tile(float (*o)[4],
                                        float (*p)[4],
                                        const float* vt, int stride, int dp,
                                        int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    uint32_t ah[4], al[4];
    split_tf32(p[kk][0], ah[0], al[0]);   // row g, key 2t
    split_tf32(p[kk][2], ah[1], al[1]);   // row g + 8, key 2t
    split_tf32(p[kk][1], ah[2], al[2]);   // row g, key 2t + 1
    split_tf32(p[kk][3], ah[3], al[3]);   // row g + 8, 2t + 1
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      if (n * 8 < dp) {
        const float* vb = vt + (kk * 8 + 2 * t) * stride + n * 8 + g;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(vb[0], bh0, bl0);
        split_tf32(vb[stride], bh1, bl1);
        mma_split(o[n], ah, al, bh0, bh1, bl0, bl1);
      }
    }
  }
}

// bf16: the S fragments of n-tiles 2kk and 2kk + 1 are P's A fragment as
// they are (FlashAttention-2)
template <int DP, int BK>
__device__ __forceinline__ void pv_tile(float (*o)[4],
                                        float (*p)[4],
                                        const __nv_bfloat16* vt, int stride,
                                        int dp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_f32(p[2 * kk][0], p[2 * kk][1]);
    a[1] = pack_f32(p[2 * kk][2], p[2 * kk][3]);
    a[2] = pack_f32(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[3] = pack_f32(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      if (n * 8 < dp) {
        const __nv_bfloat16* vb = vt + (kk * 16 + 2 * t) * stride + n * 8 + g;
        const uint32_t b0 = pack_bf16(vb[0], vb[stride]);
        const uint32_t b1 = pack_bf16(vb[8 * stride], vb[9 * stride]);
        mma_bf16(o[n], a, b0, b1);
      }
    }
  }
}

}  // namespace
}  // namespace repro
