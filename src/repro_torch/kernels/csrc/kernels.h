// Launch interface shared by the port's CUDA kernels and bindings.cpp.
#pragma once

#include <cuda_runtime.h>

namespace repro {

// One greedy, class-free Steps-1..3 scheduling pass over B lanes of W slots
// (row-major (B, W) tensors, slots in FCFS order).  `act` is (B, W) bytes, or
// one byte a lane when `act_lane` is set; `depth` may be null (unbounded
// EASY scan).  Outputs may not alias inputs.  The launch plan
// (kernels/schedule_tick.py::plan): `tier`, `threads` a CTA (32 a lane in
// the warp tier), `k` slots a thread and `cluster` CTAs a lane; the global
// tier keeps the rows in `scratch`, B * cluster * threads * k * 37 bytes
// (null in the other tiers).
enum TickTier : int { kTickWarp = 0, kTickCta = 1, kTickCluster = 2,
                      kTickGlobal = 3 };

struct TickArgs {
  const int* state;
  const int* alloc;
  const float* remaining;
  const float* start_t;
  const unsigned char* act;
  const unsigned char* malleable;
  const int* want;
  const int* floor_nodes;
  const int* shrink_floor;
  const int* prio_ref;
  const int* max_nodes;
  const float* pfrac;
  const float* wall_work;
  const int* capacity;  // (B,)
  const float* t_now;   // (B,)
  const int* depth;     // (B,) or null
  int* out_state;
  int* out_alloc;
  float* out_start;
  unsigned char* scratch;
  int B;
  int W;
  int act_lane;
  int tier, threads, k, cluster;
  int fill_rounds;
  int prio_lo;
  int prio_hi;
  int shadow_iters;
  // take_desc_prefix bounds (lo, hi] and bisection rounds of the Step-2
  // shrink and the Step-3 give, from prio_lo / prio_hi as the plain pass
  // derives them (kernels/schedule_tick.py::bisect_bounds)
  int take_lo, take_hi, take_iters;
  int give_lo, give_hi, give_iters;
};

cudaError_t launch_schedule_tick(const TickArgs& args, cudaStream_t stream);

// Per-row prefix waterfill over B rows of N int32 capacities (row-major):
// take = clip(target - exclusive_cumsum(cap), 0, cap).  `target` is (B,),
// one int for every row (`target_shared`), or null for `target_value`.
// `order` (null, or a (B, N) int64 permutation of each row) reads cap and
// writes out in that order: out[order[i]] takes cap[order[i]].  The launch
// plan (kernels/waterfill.py::plan): `tier`, `threads` a CTA, `k` slots a
// thread (the warp tier gives each row one warp, several rows a CTA; the
// look-back tier cuts rows into tiles of threads * k slots); `vec`: 16-byte
// loads and stores (no order, k % 4 == 0, cap and out 16-byte aligned and
// every row starting on 4 ints).  `scratch`: the look-back tier's tile
// counter and descriptors, 1 + B * ceil(N / (threads * k)) words (null in
// the other tiers), cleared by the launch.  Outputs may not alias inputs.
enum WaterfillTier : int { kWaterfillWarp = 0, kWaterfillCta = 1,
                           kWaterfillLookback = 2 };

struct WaterfillArgs {
  const int* cap;
  const int* target;
  const long long* order;
  int* out;
  unsigned long long* scratch;
  int B, N;
  int target_value, target_shared;
  int tier, threads, k, vec;
};

cudaError_t launch_waterfill(const WaterfillArgs& args, cudaStream_t stream);

// Element type of the LLM kernels' activations and weights (states are
// f32).
enum DType : int { kF32 = 0, kBF16 = 1 };

// RMSNorm over `rows` contiguous rows of width d: x * rsqrt(mean(x^2) + eps)
// * w in f32, written in x's type; w: (d,).  `plan` packs
// (kernels/rmsnorm.py::pack) bits 0-1: x's and w's DType; 2-7: vec, the
// elements a load moves (1, or 16 bytes of x when d and the pointers allow
// it); 8-12: k, the vectors a thread holds; 13-15: rows a CTA (a warp each)
// when above 1, else one row a CTA; 16-26: threads a CTA.
struct NormArgs {
  const void* x;
  const void* w;
  void* out;
  int rows, d;
  float eps;
  int dtype, wdtype, vec, k, rows_per_cta, threads;
};
cudaError_t launch_rmsnorm(const NormArgs& args, cudaStream_t stream);

// RMSNorm's gradient over `rows` contiguous rows of width d, given the
// output's gradient dy (x's type): dx = r (w dy) - x r^3 mean(x w dy) with
// r = rsqrt(mean(x^2) + eps), written in x's type; dw = sum over rows of
// dy x r, in w's type (csrc/rmsnorm_bwd.cu).  The launch plan
// (kernels/rmsnorm.py::bwd_plan, packed by bwd_pack) bits 0-1: x's and w's
// DType; 2-5: vec, the elements a load moves; 6-11: k, the vectors of a row
// a thread takes; 12-15: cluster, the CTAs of a thread block cluster; 16-26:
// threads a CTA; 27: a warp a row (else the CTA takes one row at a time);
// 28-29: depth, the rows of x and dy a thread holds in registers (2: the
// next row loads while one is reduced; 0: the row is walked twice, a CTA a
// row, one CTA a cluster).  `ctas` CTAs walk the rows; each cluster writes
// its column sums to a row of `partial` (f32, ctas / cluster x d; unused,
// and may be null, for one cluster of depth 1 or 2), which a second kernel
// adds up in a fixed order, so dw has the same bits on every run.
struct NormBwdArgs {
  const void* x;
  const void* w;
  const void* dy;
  void* dx;
  void* dw;
  float* partial;
  int rows, d, ctas;
  float eps;
  int dtype, wdtype, vec, k, cluster, threads, warp_rows, depth;
};
cudaError_t launch_rmsnorm_bwd(const NormBwdArgs& args, cudaStream_t stream);

// Online-softmax attention.  q: (B, Sq, H, D); k: (B, Sk, Hkv, D); v:
// (B, Sk, Hkv, Dv) with Dv <= D; o: (B, Sq, H, Dv); all contiguous and of
// one type; query head h reads KV head h / (H / Hkv).
// Query i sits at absolute position q_offset + i, key j at j; key j is seen
// when j < kv_valid, (causal) j <= query position and (window > 0)
// j > query position - window.  Rows that see no key are 0.  D <= 256.
//
// n_split == 0 selects the prefill variant (tensor cores, 64 queries of one
// head per CTA).  n_split >= 1 selects the split-KV decode variant (needs
// (H / Hkv) * Sq <= 16 and Dv == D): the visible keys are cut into n_split
// ranges, each CTA writes its rows' (acc, m, l) to `scratch`, f32 of shape
// (B, H, Sq, n_split, D + 2), and a second kernel combines the splits.
// `lse`, null or f32 (B, H, Sq), takes each row's log-sum-exp of its scaled
// scores (+inf for a row that sees no key): the prefill variant writes it
// for the backward; the decode variant refuses it.
struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* scratch;
  float* lse;
  int B, Sq, Sk, H, Hkv, D, Dv;
  int q_offset, kv_valid, window, causal;
  float scale;
  int n_split;
};
cudaError_t launch_flash_attention(const AttnArgs& args, int dtype,
                                   cudaStream_t stream);

// The gradient of the prefill variant's attention (q_offset 0, every key
// valid), given the forward's output o and row log-sum-exp lse (B, H, Sq),
// and the output's gradient dout (o's shape and type).  Writes dq (q's
// shape), dk and dv (k's and v's), all of q's type.  `delta`: f32 scratch
// (B, H, Sq), each row's sum of dout * o.  The dK / dV kernel takes a tile
// of keys of one KV head and walks the query tiles of all H / Hkv heads of
// its group that see it; the dQ kernel takes a tile of queries of one head
// and walks the key tiles it sees.  No atomics: every output element is
// written once, by one thread.
struct AttnBwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Sk, H, Hkv, D, Dv;
  int window, causal;
  float scale;
};
cudaError_t launch_flash_attention_bwd(const AttnBwdArgs& args, int dtype,
                                       cudaStream_t stream);

// Mamba-2 chunked SSD scan.  x: (B, S, H, P); dt: (B, S, H); b, c: (B, S, N)
// of one type; a: (H,) f32; init: (B, H, P, N) f32 or null.  Writes
// y: (B, S, H, P) f32 and state: (B, H, P, N) f32.  L is the chunk length
// (at most 128); scan_ctas the CTAs of the chunk-scan kernel, from B * NC
// (all of a chunk's heads in one CTA) to B * NC * H (one head a CTA).
// scratch: f32, the chunks' states (B, NC, H, P, N) then their last cumsums
// (B, NC, H), NC = ceil(S / L); null when S = 0.  P <= 128.
struct SsdArgs {
  const void* x;
  const void* dt;
  const float* a;
  const void* b;
  const void* c;
  const float* init;
  float* y;
  float* state;
  float* scratch;
  int B, S, H, P, N, L, scan_ctas;
};
cudaError_t launch_ssd_scan(const SsdArgs& args, int dtype,
                            cudaStream_t stream);

// The gradient of launch_ssd_scan (ssd_scan_bwd.cu).  x, dt, b, c as the
// forward took them; dy: (B, S, H, P) f32; dstate: (B, H, P, N) f32 or
// null (no pull on the final state); states: the forward's scratch, run at
// this L (the states before each chunk, then the chunks' last cumsums).
// Writes dx, ddt, db, dc in the inputs' type, da (H,) f32 and, when not
// null, dinit (B, H, P, N) f32.  groups: the head groups of a chunk, one
// chunk-scan CTA each (1 to H).  scratch: f32, B * NC * H * (P * N + X + 1)
// + 2 * B * NC * groups * L * N floats, X = ceil(P * N / 256).  P, N <= 128.
struct SsdBwdArgs {
  const void* x;
  const void* dt;
  const float* a;
  const void* b;
  const void* c;
  const float* dy;
  const float* dstate;
  const float* states;
  void* dx;
  void* ddt;
  void* db;
  void* dc;
  float* da;
  float* dinit;
  float* scratch;
  int B, S, H, P, N, L, groups;
};
cudaError_t launch_ssd_scan_bwd(const SsdBwdArgs& args, int dtype,
                                cudaStream_t stream);

}  // namespace repro
