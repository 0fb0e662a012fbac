// Fused greedy Steps-1..3 scheduling pass for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/schedule_tick.py::_tick_kernel
// (wrapper fused_schedule_tick): one whole greedy, class-free pass per lane --
// FCFS prefix start with a head floor fallback, the EASY shadow-time
// reservation (float bisection with snapping), `fill_rounds` three-class
// cumulative-fit backfill rounds with an optional queue-rank depth cutoff, the
// greedy shrink (integer threshold bisection) that admits the head, and the
// greedy expand.  Outputs are bit-equal to the plain pass in
// repro_torch/core/passes.py: integer sums and scans are exact in any order,
// float maxima are order-free, and the float expressions keep their
// evaluation order (build with --fmad=false and IEEE division; no fast math).
//
// Bound on this card: not bytes (64 per slot, read once and written once)
// but the chain of ~70 dependent team-wide steps -- the Step-1 scan, the
// queue snapshot, 26 shadow rounds, 3 * fill_rounds class scans, two integer
// threshold bisections of ~log2(priority range) rounds and their tie scans.
// Each step is a short walk over the slots a thread owns and one reduction
// or scan across the lane's threads, so a pass costs ~70 synchronisation
// latencies, and the design makes each one as short as the row allows:
//
// * The lane's row is loaded once into per-slot arrays (al, est / amount,
//   fit / priority, want, floor, shrink floor, priority reference, max nodes,
//   start, flags: 37 bytes a slot), each slot owned by one thread, which
//   holds k consecutive slots (stored [j][thread] so accesses do not share
//   banks).  State, alloc and start are written once at the end.  The end
//   estimate of every running slot and the fit time of every queued one are
//   computed once at load (a Step-1 start at the head fallback gets its own).
// * Every reduction and scan costs one barrier: warps reduce with
//   __reduce_*_sync / shuffles, write one partial into a double-buffered
//   array, synchronise once, and every warp then reduces all partials with
//   shuffles.  Reductions taken at one point are fused (Step 1's used and
//   head; the snapshot's head, depth cut and the shadow's upper bound; each
//   shadow round's released sum and snapped maximum; the last fill class's
//   take with the shrink surplus and the expand flag).
// * Tiers by row length (kernels/schedule_tick.py::plan picks one):
//   warp -- W <= 256: one warp, one CTA per lane, no __syncthreads at all:
//     every step is warp shuffles and redux (one warp a CTA ran as fast as
//     four at W = 128 and faster at 256);
//   cta -- one CTA per lane sized to the row (8 slots a thread), the row in
//     shared memory, up to 4,096 slots;
//   cluster -- a thread block cluster of 2-8 CTAs shares a longer row (up
//     to 8 * 4,096 slots): partials cross the cluster through distributed
//     shared memory and one cluster barrier per step, and the load and the
//     walks spread over B * cluster CTAs (haswell's 16 lanes x 16,384 slots
//     on 128).  A cluster barrier costs more than a CTA barrier, so a row
//     that fits one CTA is not split;
//   global -- rows longer than a cluster holds keep the same arrays in a
//     device-memory scratch (coalesced: [j][thread]) and run the same code,
//     with k slots a thread and a cluster where the lanes leave SMs free.
#include <cooperative_groups.h>
#include <limits.h>
#include <math.h>

#include "kernels.h"
#include "mma.cuh"

namespace repro {
namespace {

namespace cg = cooperative_groups;

constexpr int kQueued = 1;
constexpr int kRunning = 2;
constexpr float kShadowEps = 1e-3f;
constexpr unsigned kFull = 0xffffffffu;

// per-slot flags: bits 0-1 the state, then act, malleable, started
constexpr int kStateBits = 3;
constexpr int kAct = 4;
constexpr int kMall = 8;
constexpr int kStarted = 16;
constexpr int kQueuedAct = kQueued | kAct;

// queued and eligible for a state change (the pass's `queued & act`)
__device__ __forceinline__ bool queued_act(int flags) {
  return (flags & (kStateBits | kAct)) == kQueuedAct;
}

constexpr int kSlotBytes = 37;      // 9 four-byte arrays + the flags byte
constexpr int kPartBytes = 2 * 32 * 16;  // two buffers of 32 int4 partials
constexpr int kMaxParts = 128;      // CTAs a lane x warps a CTA (8 x 16)
constexpr int kMaxThreads = 512;

enum Team { kWarpTeam, kCtaTeam, kClusterTeam };
enum Op { kSum, kMax, kMin };

template <Op O>
__device__ __forceinline__ int apply(int a, int b) {
  if constexpr (O == kSum) return a + b;
  else if constexpr (O == kMax) return max(a, b);
  else return min(a, b);
}

template <Op O>
__device__ __forceinline__ int identity() {
  if constexpr (O == kSum) return 0;
  else if constexpr (O == kMax) return INT_MIN;
  else return INT_MAX;
}

template <Op O>
__device__ __forceinline__ int warp_all(int v) {
  if constexpr (O == kSum) return __reduce_add_sync(kFull, v);
  else if constexpr (O == kMax) return __reduce_max_sync(kFull, v);
  else return __reduce_min_sync(kFull, v);
}

// Floats as ints of the same order (no NaN reaches them), so a float maximum
// rides an integer reduction; the map is its own inverse.
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float from_ordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

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

// The threads of one lane: a warp, a CTA or a cluster of CTAs.  `part` holds
// each warp's partial, double-buffered: a step writes buffer `buf`, crosses
// one barrier, reads every partial and flips `buf`, so the next step's
// writes cannot race this step's reads.
struct Team_ {
  int4* part;
  int buf;
  int nw;     // warps a CTA
  int ctas;   // CTAs a lane
  int rank;   // this CTA's rank among them
  int warp;
  int lane;
};

template <Team T>
__device__ __forceinline__ void team_sync() {
  if constexpr (T == kCtaTeam) __syncthreads();
  else if constexpr (T == kClusterTeam) cg::this_cluster().sync();
}

template <Team T>
__device__ __forceinline__ int4 load_part(const Team_& c, int idx) {
  if constexpr (T == kClusterTeam) {
    const int r = idx / c.nw;
    int4* p = c.part + c.buf * 32 + (idx - r * c.nw);
    return *cg::this_cluster().map_shared_rank(p, r);
  } else {
    return c.part[c.buf * 32 + idx];
  }
}

// Team-wide reduction of up to three ints, each with its own operator.
template <Team T, int N, Op A, Op B = kSum, Op C = kSum>
__device__ __forceinline__ int3 reduce(Team_& c, int x, int y = 0,
                                       int z = 0) {
  x = warp_all<A>(x);
  if constexpr (N > 1) y = warp_all<B>(y);
  if constexpr (N > 2) z = warp_all<C>(z);
  if constexpr (T == kWarpTeam) {
    return make_int3(x, y, z);
  } else {
    if (c.lane == 0) c.part[c.buf * 32 + c.warp] = make_int4(x, y, z, 0);
    team_sync<T>();
    x = identity<A>();
    y = identity<B>();
    z = identity<C>();
    const int parts = c.nw * c.ctas;
#pragma unroll
    for (int m = 0; m < kMaxParts / 32; ++m) {
      const int idx = c.lane + 32 * m;
      if (idx < parts) {
        const int4 q = load_part<T>(c, idx);
        x = apply<A>(x, q.x);
        if constexpr (N > 1) y = apply<B>(y, q.y);
        if constexpr (N > 2) z = apply<C>(z, q.z);
      }
    }
    c.buf ^= 1;
    x = warp_all<A>(x);
    if constexpr (N > 1) y = warp_all<B>(y);
    if constexpr (N > 2) z = warp_all<C>(z);
    return make_int3(x, y, z);
  }
}

// Exclusive prefix sum of `v` over the team in slot order; *total gets the
// team's sum of `v` and *extra_sum that of `extra` (a sum that can ride the
// same barrier).
template <Team T>
__device__ __forceinline__ int scan(Team_& c, int v, int extra, int* total,
                                    int* extra_sum) {
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, incl, o);
    if (c.lane >= o) incl += n;
  }
  extra = __reduce_add_sync(kFull, extra);
  if constexpr (T == kWarpTeam) {
    *total = __shfl_sync(kFull, incl, 31);
    *extra_sum = extra;
    return incl - v;
  } else {
    if (c.lane == 31)
      c.part[c.buf * 32 + c.warp] = make_int4(incl, extra, 0, 0);
    team_sync<T>();
    const int mine = c.rank * c.nw + c.warp;
    const int parts = c.nw * c.ctas;
    int before = 0, tot = 0, ex = 0;
#pragma unroll
    for (int m = 0; m < kMaxParts / 32; ++m) {
      const int idx = c.lane + 32 * m;
      if (idx < parts) {
        const int4 q = load_part<T>(c, idx);
        tot += q.x;
        ex += q.y;
        if (idx < mine) before += q.x;
      }
    }
    c.buf ^= 1;
    *total = __reduce_add_sync(kFull, tot);
    *extra_sum = __reduce_add_sync(kFull, ex);
    return __reduce_add_sync(kFull, before) + incl - v;
  }
}

// KC: slots a thread, or 0 for the global tier's runtime count (a.k).
template <Team T, int KC>
__global__ void __launch_bounds__(kMaxThreads) tick_kernel(TickArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = KC > 0 ? KC : a.k;
  const int W = a.W;
  Team_ c;
  c.buf = 0;
  c.warp = threadIdx.x >> 5;
  c.lane = threadIdx.x & 31;
  c.ctas = 1;
  c.rank = 0;
  int lane_b, t, stride;
  unsigned char* store;
  if constexpr (T == kWarpTeam) {
    lane_b = blockIdx.x;
    c.part = nullptr;
    c.nw = 1;
    t = c.lane;
    stride = 32;
    store = smem;
  } else {
    if constexpr (T == kClusterTeam) {
      c.rank = static_cast<int>(cg::this_cluster().block_rank());
      c.ctas = static_cast<int>(cg::this_cluster().num_blocks());
    }
    lane_b = blockIdx.x / c.ctas;
    c.part = reinterpret_cast<int4*>(smem);
    c.nw = blockDim.x >> 5;
    t = threadIdx.x;
    stride = blockDim.x;
    store = a.scratch != nullptr
                ? a.scratch + static_cast<size_t>(blockIdx.x) * stride * k *
                                  kSlotBytes
                : smem + kPartBytes;
  }
  const int n = stride * k;
  int* al = reinterpret_cast<int*>(store);
  int* ev = al + n;      // end estimate (float bits), later the take amount
  int* fv = ev + n;      // fit time (float bits), later the take priority
  int* wantv = fv + n;
  int* floorv = wantv + n;
  int* sfloorv = floorv + n;
  int* prefv = sfloorv + n;
  int* mxv = prefv + n;
  float* s0 = reinterpret_cast<float*>(mxv + n);
  unsigned char* fl = reinterpret_cast<unsigned char*>(s0 + n);

  // this thread's slots: first + j for j < k, inside [lo, hi) of its CTA
  const int span = T == kWarpTeam ? W : (W + c.ctas - 1) / c.ctas;
  const int lo = c.rank * span;
  const int hi = min(lo + span, W);
  const int first = lo + t * k;
  auto each = [&](auto&& f) {
    if constexpr (KC > 0) {
#pragma unroll
      for (int j = 0; j < KC; ++j) f(j * stride + t, first + j);
    } else {
      for (int j = 0; j < k; ++j) f(j * stride + t, first + j);
    }
  };
  // the storage handle of slot i when this thread owns it, else -1
  auto handle_of = [&](int i) -> int {
    const int d = i - first;
    return i < hi && d >= 0 && d < k ? d * stride + t : -1;
  };

  const size_t off = static_cast<size_t>(lane_b) * W;
  const int capacity = a.capacity[lane_b];
  const float t_now = a.t_now[lane_b];
  const bool bounded = a.depth != nullptr;
  const int depth = bounded ? a.depth[lane_b] : 0;
  const int lane_act = a.act_lane ? a.act[lane_b] : 0;
  const int inf_bits = __float_as_int(INFINITY);

  // -- load: the row once, end estimates and fit times once ----------------
  int busy = 0;
  each([&](int h, int i) {
    if (i < hi) {
      const int s = a.state[off + i];
      const int x = a.alloc[off + i];
      const int ac = a.act_lane ? lane_act : a.act[off + i];
      const int w = a.want[off + i];
      const float p = a.pfrac[off + i];
      const float wall = a.wall_work[off + i];
      const float r = a.remaining[off + i];
      const bool run = s == kRunning;
      // end estimate of a running slot, and of a queued one should Step 1
      // start it at its want
      float e = INFINITY;
      if (run) e = t_now + r * wall / speedup(x, p);
      else if (s == kQueued && ac) e = t_now + r * wall / speedup(w, p);
      al[h] = x;
      ev[h] = __float_as_int(e);
      fv[h] = __float_as_int(t_now + wall / speedup(w, p));
      wantv[h] = w;
      floorv[h] = a.floor_nodes[off + i];
      sfloorv[h] = a.shrink_floor[off + i];
      prefv[h] = a.prio_ref[off + i];
      mxv[h] = a.max_nodes[off + i];
      s0[h] = a.start_t[off + i];
      fl[h] = static_cast<unsigned char>((s & kStateBits) | (ac ? kAct : 0) |
                                         (a.malleable[off + i] ? kMall : 0));
      if (run) busy += x;
    } else {
      al[h] = 0;
      ev[h] = inf_bits;
      wantv[h] = 0;
      floorv[h] = 0;
      sfloorv[h] = 0;
      prefv[h] = 0;
      mxv[h] = 0;
      fl[h] = 0;
    }
  });
  auto start = [&](int h, int alloc) {
    al[h] = alloc;
    fl[h] = static_cast<unsigned char>((fl[h] & ~kStateBits) | kRunning |
                                       kStarted);
  };

  // -- Step 1: FCFS prefix + head floor fallback ----------------------------
  int free_n;
  {
    int q = 0;
    each([&](int h, int) {
      if (queued_act(fl[h])) q += wantv[h];
    });
    int tot, busy_all;
    int cum = scan<T>(c, q, busy, &tot, &busy_all);
    free_n = capacity - busy_all;
    int used = 0, head = W;
    each([&](int h, int i) {
      if (queued_act(fl[h])) {
        cum += wantv[h];
        if (cum <= free_n) {
          start(h, wantv[h]);
          used = max(used, cum);
        } else {
          head = min(head, i);
          ev[h] = inf_bits;  // stays queued
        }
      }
    });
    const int3 r = reduce<T, 2, kMax, kMin>(c, used, head);
    used = r.x;
    head = r.y;
    const int leftover = free_n - used;
    const int hfloor = head < W ? a.floor_nodes[off + head] : 0;
    const int hwant = head < W ? a.want[off + head] : 0;
    const bool h_ok = hfloor > 0 && hfloor <= leftover;
    const int h_alloc = clampi(leftover, hfloor, hwant);
    const int hh = h_ok ? handle_of(head) : -1;
    if (hh >= 0) {
      start(hh, h_alloc);
      ev[hh] = __float_as_int(
          t_now + a.remaining[off + head] * a.wall_work[off + head] /
                      speedup(h_alloc, a.pfrac[off + head]));
    }
    free_n = leftover - (h_ok ? h_alloc : 0);
  }

  // -- EASY backfill under the head's shadow-time reservation --------------
  // Queue snapshot at scan entry: the head is the first queued slot, and the
  // depth cutoff is the (depth + 2)-th queued slot (ranks <= depth + 1
  // pass).  The shadow bisection's upper bound rides the same reduction.
  int head = W, cut = W;
  float hi_e;
  {
    int hi_o = ordered(-INFINITY);
    int rank = 0;
    if (bounded) {
      int q = 0;
      each([&](int h, int) { q += queued_act(fl[h]) ? 1 : 0; });
      int tot, unused;
      rank = scan<T>(c, q, 0, &tot, &unused);
    }
    each([&](int h, int i) {
      if (queued_act(fl[h])) {
        ++rank;
        head = min(head, i);
        if (bounded && rank > depth + 1) cut = min(cut, i);
      }
      const float e = __int_as_float(ev[h]);
      if (isfinite(e)) hi_o = max(hi_o, ordered(e));
    });
    const int3 r = reduce<T, 3, kMin, kMin, kMax>(c, head, cut, hi_o);
    head = r.x;
    cut = r.y;
    hi_e = from_ordered(r.z);
  }
  const int hfloor = head < W ? a.floor_nodes[off + head] : 0;
  const int hwant = head < W ? a.want[off + head] : 0;
  const bool has_head = hfloor > 0;
  const bool blocked = has_head && hfloor > free_n;

  float shadow = has_head ? t_now : INFINITY;
  int extra = has_head ? free_n - hfloor : free_n;
  const int free_at_shadow = free_n;
  int rel_hi = 0;  // this thread's release by the shadow time
  if (blocked && a.fill_rounds > 0) {
    const int need = hfloor - free_n;
    float lo_e = 0.0f;
    for (int it = 0; it < a.shadow_iters; ++it) {
      const float mid = 0.5f * (lo_e + hi_e);
      int rel = 0, snap = ordered(-INFINITY);
      each([&](int h, int) {
        const float e = __int_as_float(ev[h]);
        if (isfinite(e) && e <= mid) {
          rel += al[h];
          snap = max(snap, ordered(e));
        }
      });
      const int3 r = reduce<T, 2, kSum, kMax>(c, rel, snap);
      const bool ok = r.x >= need;
      hi_e = ok ? from_ordered(r.y) : hi_e;
      lo_e = ok ? lo_e : mid;
    }
    shadow = hi_e;
    each([&](int h, int) {
      const float e = __int_as_float(ev[h]);
      if (isfinite(e) && e <= hi_e) rel_hi += al[h];
    });
  }
  const float shadow_lim = shadow + kShadowEps;

  // surplus over the shrink floor (the Step-2 take amount) and its priority,
  // once the fills are done; returns (sum of surplus, any expandable slot)
  auto surplus = [&](int* tot, int* any_exp) {
    each([&](int h, int) {
      const int f = fl[h];
      const int x = al[h];
      const bool shrinkable = (f & kStateBits) == kRunning && (f & kMall);
      const int floor_x = shrinkable ? min(sfloorv[h], x) : x;
      const int s = max(x - floor_x, 0);
      ev[h] = s;
      fv[h] = clampi(x - prefv[h], a.prio_lo, a.prio_hi);
      *tot += s;
      *any_exp |= shrinkable ? 1 : 0;
    });
  };
  int tot_surplus = 0, any_exp = 0;

  for (int r = 0; r < a.fill_rounds; ++r) {
    // Three cumulative-fit admission classes.  Each applies its starts as it
    // scans, so later classes see them as no longer queued.
    for (int cls = 0; cls < 3; ++cls) {
      const int lim = cls == 0 ? free_n : min(free_n, extra);
      // a candidate of this class, and the nodes it would take
      auto admits = [&](int h, int i, int* amt) -> bool {
        if (!queued_act(fl[h]) || i == head || i >= cut) return false;
        const bool tfit = __int_as_float(fv[h]) <= shadow_lim;
        *amt = cls == 2 ? floorv[h] : wantv[h];
        return (cls == 0 ? tfit : !tfit) && *amt <= lim;
      };
      int q = 0;
      each([&](int h, int i) {
        int amt;
        if (admits(h, i, &amt)) q += amt;
      });
      const bool first_class = r == 0 && cls == 0;
      int tot, rel;
      int cum = scan<T>(c, q, first_class ? rel_hi : 0, &tot, &rel);
      if (first_class && blocked) extra = free_at_shadow + rel - hfloor;
      int take = 0;
      each([&](int h, int i) {
        int amt;
        if (admits(h, i, &amt)) {
          cum += amt;
          if (cum <= lim) {
            start(h, amt);
            take = max(take, cum);
          }
        }
      });
      const bool last = r == a.fill_rounds - 1 && cls == 2;
      if (last) surplus(&tot_surplus, &any_exp);
      const int3 t3 = reduce<T, 3, kMax, kSum, kMax>(c, take, tot_surplus,
                                                     any_exp);
      if (last) {
        tot_surplus = t3.y;
        any_exp = t3.z;
      }
      free_n -= t3.x;
      if (cls > 0) extra -= t3.x;
    }
  }
  if (a.fill_rounds <= 0) {
    surplus(&tot_surplus, &any_exp);
    const int3 t3 = reduce<T, 2, kSum, kMax>(c, tot_surplus, any_exp);
    tot_surplus = t3.x;
    any_exp = t3.y;
  }

  // take_desc_prefix over (fv = priority, ev = amount): the per-slot take
  // with sum == min(need, sum(amount)), highest priority first, ties in slot
  // order; `sign` adds (+1) or removes (-1) each take from the allocation.
  auto take_desc = [&](int need, int plo, int phi, int iters, int sign) {
    int s_hi = 0;
    for (int it = 0; it < iters; ++it) {
      const int mid = floordiv2(plo + phi);
      int s = 0;
      each([&](int h, int) { s += fv[h] > mid ? ev[h] : 0; });
      s = reduce<T, 1, kSum>(c, s).x;
      if (s <= need) {
        phi = mid;
        s_hi = s;
      } else {
        plo = mid;
      }
    }
    const int theta = phi;
    const int rem_need = need - s_hi;
    int tie = 0;
    each([&](int h, int) { tie += fv[h] == theta ? ev[h] : 0; });
    int tot, unused;
    int before = scan<T>(c, tie, 0, &tot, &unused);
    each([&](int h, int) {
      const int pr = fv[h];
      const int am = ev[h];
      int take = 0;
      if (pr > theta) {
        take = am;
      } else if (pr == theta) {
        before += am;
        take = min(max(rem_need - (before - am), 0), am);
      }
      al[h] += sign * take;
    });
  };

  // -- Step 2: greedy shrink to admit the head ------------------------------
  {
    const int deficit = has_head ? hfloor - free_n : 0;
    const int need = (deficit > 0 && tot_surplus >= deficit) ? deficit : 0;
    if (need > 0) take_desc(need, a.take_lo, a.take_hi, a.take_iters, -1);
    free_n += need;
  }
  {
    const bool h_ok = has_head && hfloor <= free_n;
    const int h_alloc = clampi(free_n, hfloor, hwant);
    const int hh = h_ok ? handle_of(head) : -1;
    if (hh >= 0) start(hh, h_alloc);
    if (h_ok && a.malleable[off + head]) any_exp = 1;
    free_n -= h_ok ? h_alloc : 0;
  }

  // -- Step 3: greedy expand into idle nodes --------------------------------
  const int idle = max(any_exp ? free_n : 0, 0);
  if (idle > 0) {
    each([&](int h, int) {
      const int f = fl[h];
      const int x = al[h];
      const bool expandable = (f & kStateBits) == kRunning && (f & kMall);
      ev[h] = expandable ? max(mxv[h] - x, 0) : 0;
      fv[h] = -clampi(x - prefv[h], a.prio_lo, a.prio_hi);
    });
    take_desc(idle, a.give_lo, a.give_hi, a.give_iters, 1);
  }

  // -- write state, alloc and start once ------------------------------------
  each([&](int h, int i) {
    if (i < hi) {
      const int f = fl[h];
      a.out_state[off + i] = f & kStateBits;
      a.out_alloc[off + i] = al[h];
      a.out_start[off + i] = (f & kStarted) ? t_now : s0[h];
    }
  });
  // no CTA of a cluster leaves while another may still read its partials
  if constexpr (T == kClusterTeam) cg::this_cluster().sync();
}

template <Team T, int KC>
cudaError_t launch_tier(const TickArgs& a, int grid, int threads, size_t smem,
                        cudaStream_t stream) {
  cudaError_t err = allow_smem<tick_kernel<T, KC>>(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = T == kClusterTeam ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, tick_kernel<T, KC>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Dynamic shared memory of a launch plan (plan() in kernels/schedule_tick.py
// mirrors it): the rows of a warp's lanes, the partials alone (global tier),
// or the partials and the CTA's rows.
size_t schedule_tick_smem(int tier, int threads, int k) {
  if (tier == kTickWarp) return static_cast<size_t>(threads) * k * kSlotBytes;
  if (tier == kTickGlobal) return kPartBytes;
  return kPartBytes + static_cast<size_t>(threads) * k * kSlotBytes;
}

}  // namespace

cudaError_t launch_schedule_tick(const TickArgs& a, cudaStream_t stream) {
  if (a.B <= 0 || a.W <= 0) return cudaSuccess;
  const int tier = a.tier, threads = a.threads, k = a.k, cl = a.cluster;
  const size_t smem = schedule_tick_smem(tier, threads, k);
  // the plan must own every slot exactly once and fit the card
  const bool shape_ok = threads >= 32 && threads % 32 == 0 &&
                        threads <= kMaxThreads && k >= 1 && cl >= 1 &&
                        cl <= 8 && smem <= 232448;
  if (!shape_ok) return cudaErrorInvalidValue;
  const long long span = (static_cast<long long>(a.W) + cl - 1) / cl;
  switch (tier) {
    case kTickWarp:
      if (cl != 1 || threads != 32 || (k != 4 && k != 8) || 32LL * k < a.W ||
          a.scratch != nullptr)
        return cudaErrorInvalidValue;
      return k == 4 ? launch_tier<kWarpTeam, 4>(a, a.B, 32, smem, stream)
                    : launch_tier<kWarpTeam, 8>(a, a.B, 32, smem, stream);
    case kTickCta:
    case kTickCluster:
      if (k != 8 || static_cast<long long>(threads) * k < span ||
          (tier == kTickCta) != (cl == 1) || a.scratch != nullptr)
        return cudaErrorInvalidValue;
      return tier == kTickCta
                 ? launch_tier<kCtaTeam, 8>(a, a.B, threads, smem, stream)
                 : launch_tier<kClusterTeam, 8>(a, a.B * cl, threads, smem,
                                                stream);
    case kTickGlobal:
      if (static_cast<long long>(threads) * k < span || a.scratch == nullptr)
        return cudaErrorInvalidValue;
      return cl == 1 ? launch_tier<kCtaTeam, 0>(a, a.B, threads, smem, stream)
                     : launch_tier<kClusterTeam, 0>(a, a.B * cl, threads,
                                                    smem, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace repro
