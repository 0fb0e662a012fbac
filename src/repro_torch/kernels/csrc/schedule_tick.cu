// Fused greedy Steps-1..3 scheduling pass for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/schedule_tick.py::_tick_kernel
// (wrapper fused_schedule_tick): one whole greedy, class-free pass per lane --
// FCFS prefix start with a head floor fallback, the EASY shadow-time
// reservation (float bisection with snapping), `fill_rounds` three-class
// cumulative-fit backfill rounds with an optional queue-rank depth cutoff, the
// greedy shrink (integer threshold bisection) that admits the head, and the
// greedy expand.  It is an op-for-op transcription of the plain pass in
// repro_torch/core/passes.py, so outputs are bit-equal to it: integer sums and
// scans are exact in any order, float maxima are order-free, and the float
// expressions keep their evaluation order (build with --fmad=false and IEEE
// division; no fast math).
//
// Design: one CTA per lane, 512 or 1024 threads.  Every cumulative sum is a
// block-wide inclusive scan and every masked sum / max a block reduction, each
// looping over the row in blockDim-wide tiles with a carried total, so any
// window width W works (the engine's window ladder tops out at n_jobs, not at
// 2048).  Thread t always owns slots t, t + blockDim, ..., so the working
// copies of state / alloc / start_t can live in the output rows in global
// memory: each slot is only read and written by its owner.  The lax.cond
// phase skips of the JAX pass are per-lane value identities; here a lane skips
// the shadow bisection when its head is not blocked, the shrink when need is
// 0 and the expand when idle is 0.
//
// Bound on this card: the pass is latency-bound -- about 60 dependent
// block-wide passes over the row (26 shadow rounds, two integer bisections of
// ~log2(node range) rounds, 3 * fill_rounds scans), each a few
// __syncthreads, against 64 bytes of device memory traffic per slot.  The
// next step (a later PR) keeps the row in shared memory for W <= ~4096.
#include <math.h>

#include "block.cuh"
#include "kernels.h"

namespace repro {
namespace {

constexpr int kQueued = 1;
constexpr int kRunning = 2;
constexpr float kShadowEps = 1e-3f;

// Floor division by 2 (C++ '/' truncates toward zero; the bisection bounds go
// negative).
__device__ __forceinline__ int floordiv2(int x) {
  return x >= 0 ? x / 2 : -((1 - x) / 2);
}

// Amdahl speedup in float32: 1 / ((1 - p) + p / max(a, 1)).
__device__ __forceinline__ float speedup(int a, float p) {
  const float af = fmaxf(static_cast<float>(a), 1.0f);
  return 1.0f / ((1.0f - p) + p / af);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

__global__ void tick_kernel(TickArgs a) {
  __shared__ int sh_i[32];
  __shared__ float sh_f[32];
  const SumOp sum_op{};
  const MaxIntOp max_op{};
  const MinIntOp min_op{};
  const MaxFloatOp fmax_op{};

  const int b = blockIdx.x;
  const int W = a.W;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t off = static_cast<size_t>(b) * W;

  const unsigned char* act = a.act + off;
  const unsigned char* mall = a.malleable + off;
  const int* want = a.want + off;
  const int* floor_n = a.floor_nodes + off;
  const int* sfloor = a.shrink_floor + off;
  const int* pref = a.prio_ref + off;
  const int* mx = a.max_nodes + off;
  const float* rem = a.remaining + off;
  const float* pfrac = a.pfrac + off;
  const float* wall = a.wall_work + off;
  int* st = a.out_state + off;
  int* al = a.out_alloc + off;
  float* s0 = a.out_start + off;

  const int capacity = a.capacity[b];
  const float t_now = a.t_now[b];
  const float inf = INFINITY;

  // Working copies + busy nodes.
  int busy = 0;
  for (int i = tid; i < W; i += nt) {
    const int s = a.state[off + i];
    const int x = a.alloc[off + i];
    st[i] = s;
    al[i] = x;
    s0[i] = a.start_t[off + i];
    if (s == kRunning) busy += x;
  }
  int free_n = capacity - block_reduce(busy, sum_op, sh_i);

  // -- Step 1: FCFS prefix + head floor fallback ----------------------------
  {
    int carry = 0, used = 0, head = W;
    for (int base = 0; base < W; base += nt) {
      const int i = base + tid;
      const bool in = i < W;
      const bool q = in && st[i] == kQueued && act[i];
      const int w = in ? want[i] : 0;
      int tot;
      const int cum = carry + block_inclusive_scan(q ? w : 0, sh_i, &tot);
      carry += tot;
      const bool s1 = q && cum <= free_n;
      if (s1) {
        al[i] = w;
        st[i] = kRunning;
        s0[i] = t_now;
        used = max(used, cum);
      }
      if (q && !s1) head = min(head, i);
    }
    used = block_reduce(used, max_op, sh_i);
    head = block_reduce(head, min_op, sh_i);
    const int leftover = free_n - used;
    const int hfloor = head < W ? floor_n[head] : 0;
    const int hwant = head < W ? want[head] : 0;
    const bool h_ok = hfloor > 0 && hfloor <= leftover;
    const int h_alloc = clampi(leftover, hfloor, hwant);
    if (h_ok && head % nt == tid) {
      al[head] = h_alloc;
      st[head] = kRunning;
      s0[head] = t_now;
    }
    free_n = leftover - (h_ok ? h_alloc : 0);
  }

  // -- EASY backfill under the head's shadow-time reservation --------------
  // Queue snapshot at scan entry: the head is the first queued slot, and the
  // depth cutoff is the (depth + 2)-th queued slot (ranks <= depth + 1 pass).
  const bool bounded = a.depth != nullptr;
  const int depth = bounded ? a.depth[b] : 0;
  int head = W, cut = W;
  {
    int carry = 0;
    for (int base = 0; base < W; base += nt) {
      const int i = base + tid;
      const bool q = i < W && st[i] == kQueued && act[i];
      int tot;
      const int rank = carry + block_inclusive_scan(q ? 1 : 0, sh_i, &tot);
      carry += tot;
      if (q && rank == 1) head = i;
      if (q && bounded && rank > depth + 1) cut = min(cut, i);
    }
    head = block_reduce(head, min_op, sh_i);
    cut = block_reduce(cut, min_op, sh_i);
  }
  const int hfloor = head < W ? floor_n[head] : 0;
  const int hwant = head < W ? want[head] : 0;
  const bool has_head = hfloor > 0;
  const bool blocked = has_head && hfloor > free_n;

  auto est_at = [&](int i) -> float {
    return st[i] == kRunning
               ? t_now + rem[i] * wall[i] / speedup(al[i], pfrac[i])
               : inf;
  };
  float shadow;
  int extra;
  if (blocked) {
    const int need = hfloor - free_n;
    float hi = -inf;
    for (int i = tid; i < W; i += nt) {
      const float e = est_at(i);
      if (isfinite(e)) hi = fmax_op(hi, e);
    }
    hi = block_reduce(hi, fmax_op, sh_f);
    float lo = 0.0f;
    for (int it = 0; it < a.shadow_iters; ++it) {
      const float mid = 0.5f * (lo + hi);
      int rel = 0;
      float snap = -inf;
      for (int i = tid; i < W; i += nt) {
        const float e = est_at(i);
        if (isfinite(e) && e <= mid) {
          rel += al[i];
          snap = fmax_op(snap, e);
        }
      }
      rel = block_reduce(rel, sum_op, sh_i);
      snap = block_reduce(snap, fmax_op, sh_f);
      const bool ok = rel >= need;
      hi = ok ? snap : hi;
      lo = ok ? lo : mid;
    }
    int rel = 0;
    for (int i = tid; i < W; i += nt) {
      const float e = est_at(i);
      if (isfinite(e) && e <= hi) rel += al[i];
    }
    shadow = hi;
    extra = free_n + block_reduce(rel, sum_op, sh_i) - hfloor;
  } else {
    shadow = has_head ? t_now : inf;
    extra = has_head ? free_n - hfloor : free_n;
  }
  const float shadow_lim = shadow + kShadowEps;

  for (int r = 0; r < a.fill_rounds; ++r) {
    // Three cumulative-fit admission classes.  Each applies its starts as it
    // scans, so later classes see them as no longer queued (~s, ~s2).
    for (int cls = 0; cls < 3; ++cls) {
      const int lim = cls == 0 ? free_n
                               : min(free_n, extra);  // cls 2: after take2
      int carry = 0, take = 0;
      for (int base = 0; base < W; base += nt) {
        const int i = base + tid;
        bool c = i < W && st[i] == kQueued && act[i] && i != head && i < cut;
        int amt = 0;
        if (c) {
          const bool tfit =
              t_now + wall[i] / speedup(want[i], pfrac[i]) <= shadow_lim;
          amt = cls == 2 ? floor_n[i] : want[i];
          c = (cls == 0 ? tfit : !tfit) && amt <= lim;
        }
        int tot;
        const int cum = carry + block_inclusive_scan(c ? amt : 0, sh_i, &tot);
        carry += tot;
        if (c && cum <= lim) {
          al[i] = amt;
          st[i] = kRunning;
          s0[i] = t_now;
          take = max(take, cum);
        }
      }
      take = block_reduce(take, max_op, sh_i);
      free_n -= take;
      if (cls > 0) extra -= take;
    }
  }

  // take_desc_prefix: the per-slot take with sum == min(need, sum(amount)),
  // highest priority first, ties in slot order; `apply` writes each take.
  auto take_desc = [&](auto prio_of, auto amount_of, auto apply, int need,
                       int lo, int hi, int iters) {
    int s_hi = 0;
    for (int it = 0; it < iters; ++it) {
      const int mid = floordiv2(lo + hi);
      int s = 0;
      for (int i = tid; i < W; i += nt)
        if (prio_of(i) > mid) s += amount_of(i);
      s = block_reduce(s, sum_op, sh_i);
      if (s <= need) {
        hi = mid;
        s_hi = s;
      } else {
        lo = mid;
      }
    }
    const int theta = hi;
    const int rem_need = need - s_hi;
    int carry = 0;
    for (int base = 0; base < W; base += nt) {
      const int i = base + tid;
      const bool in = i < W;
      const int pr = in ? prio_of(i) : 0;
      const int am = in ? amount_of(i) : 0;
      const bool tie = in && pr == theta;
      int tot;
      const int before =
          carry + block_inclusive_scan(tie ? am : 0, sh_i, &tot);
      carry += tot;
      if (in) {
        const int take =
            pr > theta ? am : (tie ? min(max(rem_need - (before - am), 0), am)
                                   : 0);
        apply(i, take);
      }
    }
  };

  // -- Step 2: greedy shrink to admit the head ------------------------------
  {
    const int deficit = has_head ? hfloor - free_n : 0;
    auto surplus_of = [&](int i) -> int {
      const int x = al[i];
      const bool shrinkable = st[i] == kRunning && mall[i];
      const int fl = shrinkable ? min(sfloor[i], x) : x;
      return max(x - fl, 0);
    };
    int tot = 0;
    for (int i = tid; i < W; i += nt) tot += surplus_of(i);
    tot = block_reduce(tot, sum_op, sh_i);
    const int need = (deficit > 0 && tot >= deficit) ? deficit : 0;
    if (need > 0) {
      take_desc(
          [&](int i) { return clampi(al[i] - pref[i], a.prio_lo, a.prio_hi); },
          surplus_of, [&](int i, int take) { al[i] -= take; }, need,
          a.take_lo, a.take_hi, a.take_iters);
    }
    free_n += need;
  }
  {
    const bool h_ok = has_head && hfloor <= free_n;
    const int h_alloc = clampi(free_n, hfloor, hwant);
    if (h_ok && head % nt == tid) {
      al[head] = h_alloc;
      st[head] = kRunning;
      s0[head] = t_now;
    }
    free_n -= h_ok ? h_alloc : 0;
  }

  // -- Step 3: greedy expand into idle nodes --------------------------------
  {
    int any_exp = 0;
    for (int i = tid; i < W; i += nt)
      any_exp |= (st[i] == kRunning && mall[i]) ? 1 : 0;
    any_exp = block_reduce(any_exp, max_op, sh_i);
    const int idle = max(any_exp ? free_n : 0, 0);
    if (idle > 0) {
      take_desc(
          [&](int i) {
            return -clampi(al[i] - pref[i], a.prio_lo, a.prio_hi);
          },
          [&](int i) {
            return (st[i] == kRunning && mall[i]) ? max(mx[i] - al[i], 0) : 0;
          },
          [&](int i, int give) { al[i] += give; }, idle, a.give_lo,
          a.give_hi, a.give_iters);
    }
  }
}

}  // namespace

cudaError_t launch_schedule_tick(const TickArgs& args, cudaStream_t stream) {
  if (args.B <= 0 || args.W <= 0) return cudaSuccess;
  const int threads = args.W <= 512 ? 512 : 1024;
  tick_kernel<<<args.B, threads, 0, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace repro
