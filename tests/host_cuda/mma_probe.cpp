// One warp's tensor-core product under the host emulation, its fragments
// gathered from row-major A (16 x K) and B (K x 8) and its accumulator
// scattered to row-major C (16 x 8) by the layout table of csrc/mma.cuh's
// header, written out here a second time (g = lane / 4, t = lane % 4):
//   m16n8k8 tf32   A: a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//                  B: b0 (k=t, n=g)  b1 (k=t+4, n=g)
//   m16n8k16 bf16  A: a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)
//                     a3 (g+8, 2t+8..);  B: b0 (k=2t.., n=g)  b1 (k=2t+8..)
//   accumulator    c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
// tests/test_torch_mma_host.py holds C += A B to numpy's product, so a
// layout in mma.cuh's stand-in that disagrees with the table fails there.
#include "cuda_runtime.h"
#include "mma.cuh"

using namespace repro;

namespace {

enum Shape { kTf32 = 0, kSplit = 1, kBf16 = 2 };

void probe_kernel(int shape, const float* A, const float* B, float* C) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const int rows[4] = {g, g, g + 8, g + 8}, cols[4] = {2 * t, 2 * t + 1,
                                                       2 * t, 2 * t + 1};
  float c[4];
  for (int e = 0; e < 4; ++e) c[e] = C[rows[e] * 8 + cols[e]];
  if (shape == kBf16) {
    const auto a = [&](int r, int k) { return A[r * 16 + k]; };
    const auto b = [&](int k, int n) { return B[k * 8 + n]; };
    const uint32_t af[4] = {pack_f32(a(g, 2 * t), a(g, 2 * t + 1)),
                            pack_f32(a(g + 8, 2 * t), a(g + 8, 2 * t + 1)),
                            pack_f32(a(g, 2 * t + 8), a(g, 2 * t + 9)),
                            pack_f32(a(g + 8, 2 * t + 8), a(g + 8, 2 * t + 9))};
    mma_bf16(c, af, pack_f32(b(2 * t, g), b(2 * t + 1, g)),
             pack_f32(b(2 * t + 8, g), b(2 * t + 9, g)));
  } else {
    const float av[4] = {A[g * 8 + t], A[(g + 8) * 8 + t], A[g * 8 + t + 4],
                         A[(g + 8) * 8 + t + 4]};
    const float b0 = B[t * 8 + g], b1 = B[(t + 4) * 8 + g];
    if (shape == kTf32) {
      const uint32_t a[4] = {to_tf32(av[0]), to_tf32(av[1]), to_tf32(av[2]),
                             to_tf32(av[3])};
      mma_tf32(c, a, to_tf32(b0), to_tf32(b1));
    } else {
      uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
      for (int i = 0; i < 4; ++i) split_tf32(av[i], ah[i], al[i]);
      split_tf32(b0, bh0, bl0);
      split_tf32(b1, bh1, bl1);
      mma_split(c, ah, al, bh0, bh1, bl0, bl1);
    }
  }
  for (int e = 0; e < 4; ++e) C[rows[e] * 8 + cols[e]] = c[e];
}

}  // namespace

// C (16 x 8) += A B with one warp: shape 0 m16n8k8 TF32 (A 16 x 8, B 8 x 8,
// both rounded to TF32), 1 the same in split TF32, 2 m16n8k16 bf16 (A
// 16 x 16, B 16 x 8, both rounded to bf16)
extern "C" int repro_mma_probe(int shape, const float* A, const float* B,
                               float* C) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(32);
  return cudaLaunchKernelEx(&cfg, probe_kernel, shape, A, B, C);
}
