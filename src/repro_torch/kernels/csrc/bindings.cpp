// Plain C entry points of the port's kernel library, loaded with ctypes by
// repro_torch/kernels/build.py.  Pointers are tensor.data_ptr() values and the
// stream is torch.cuda.current_stream().cuda_stream; each function returns
// the cudaError_t of its launch (0 on success) so the Python wrapper raises on
// a refused launch instead of reading garbage.  repro_abi() spells each entry
// point's parameter list as the compiler sees it, which build.py compares
// with the argument types it passes.
#include <cuda_runtime.h>

#include <type_traits>

#include "kernels.h"

extern "C" {

int repro_schedule_tick(
    const void* state, const void* alloc, const void* remaining,
    const void* start_t, const void* act, const void* malleable,
    const void* want, const void* floor_nodes, const void* shrink_floor,
    const void* prio_ref, const void* max_nodes, const void* pfrac,
    const void* wall_work, const void* capacity, const void* t_now,
    const void* depth, void* out_state, void* out_alloc, void* out_start,
    void* scratch, int B, int W, int act_lane, int plan, int fill_rounds,
    int prio_lo, int prio_hi, int shadow_iters, int take_lo, int take_hi,
    int take_iters, int give_lo, int give_hi, int give_iters, void* stream) {
  repro::TickArgs a;
  a.state = static_cast<const int*>(state);
  a.alloc = static_cast<const int*>(alloc);
  a.remaining = static_cast<const float*>(remaining);
  a.start_t = static_cast<const float*>(start_t);
  a.act = static_cast<const unsigned char*>(act);
  a.malleable = static_cast<const unsigned char*>(malleable);
  a.want = static_cast<const int*>(want);
  a.floor_nodes = static_cast<const int*>(floor_nodes);
  a.shrink_floor = static_cast<const int*>(shrink_floor);
  a.prio_ref = static_cast<const int*>(prio_ref);
  a.max_nodes = static_cast<const int*>(max_nodes);
  a.pfrac = static_cast<const float*>(pfrac);
  a.wall_work = static_cast<const float*>(wall_work);
  a.capacity = static_cast<const int*>(capacity);
  a.t_now = static_cast<const float*>(t_now);
  a.depth = static_cast<const int*>(depth);
  a.out_state = static_cast<int*>(out_state);
  a.out_alloc = static_cast<int*>(out_alloc);
  a.out_start = static_cast<float*>(out_start);
  a.scratch = static_cast<unsigned char*>(scratch);
  a.B = B;
  a.W = W;
  a.act_lane = act_lane;
  // kernels/schedule_tick.py::TickPlan.code: bits 0-1 the tier, 2-5 the
  // cluster, 6-11 the warps a CTA, 12-27 the slots a thread
  a.tier = plan & 3;
  a.cluster = (plan >> 2) & 15;
  a.threads = ((plan >> 6) & 63) * 32;
  a.k = (plan >> 12) & 0xffff;
  a.fill_rounds = fill_rounds;
  a.prio_lo = prio_lo;
  a.prio_hi = prio_hi;
  a.shadow_iters = shadow_iters;
  a.take_lo = take_lo;
  a.take_hi = take_hi;
  a.take_iters = take_iters;
  a.give_lo = give_lo;
  a.give_hi = give_hi;
  a.give_iters = give_iters;
  return static_cast<int>(
      repro::launch_schedule_tick(a, static_cast<cudaStream_t>(stream)));
}

int repro_waterfill(const void* cap, const void* target, const void* order,
                    void* out, void* scratch, int B, int N, int target_value,
                    int plan, void* stream) {
  repro::WaterfillArgs a;
  a.cap = static_cast<const int*>(cap);
  a.target = static_cast<const int*>(target);
  a.order = static_cast<const long long*>(order);
  a.out = static_cast<int*>(out);
  a.scratch = static_cast<unsigned long long*>(scratch);
  a.B = B;
  a.N = N;
  a.target_value = target_value;
  // kernels/waterfill.py::pack: bits 0-1 the tier, 2-7 the slots a thread,
  // 8-13 the warps a CTA, 14 16-byte accesses, 15 one target for every row
  a.tier = plan & 3;
  a.k = (plan >> 2) & 63;
  a.threads = ((plan >> 8) & 63) * 32;
  a.vec = (plan >> 14) & 1;
  a.target_shared = (plan >> 15) & 1;
  return static_cast<int>(
      repro::launch_waterfill(a, static_cast<cudaStream_t>(stream)));
}

int repro_rmsnorm(const void* x, const void* w, void* out, int rows, int d,
                  float eps, int plan, void* stream) {
  repro::NormArgs a;
  a.x = x;
  a.w = w;
  a.out = out;
  a.rows = rows;
  a.d = d;
  a.eps = eps;
  a.dtype = plan & 1;
  a.wdtype = (plan >> 1) & 1;
  a.vec = (plan >> 2) & 63;
  a.k = (plan >> 8) & 31;
  a.rows_per_cta = (plan >> 13) & 7;
  a.threads = (plan >> 16) & 2047;
  return static_cast<int>(
      repro::launch_rmsnorm(a, static_cast<cudaStream_t>(stream)));
}

int repro_rmsnorm_bwd(const void* x, const void* w, const void* dy,
                      void* dx, void* dw, void* partial, int rows, int d,
                      int ctas, float eps, int plan, void* stream) {
  repro::NormBwdArgs a;
  a.x = x;
  a.w = w;
  a.dy = dy;
  a.dx = dx;
  a.dw = dw;
  a.partial = static_cast<float*>(partial);
  a.rows = rows;
  a.d = d;
  a.ctas = ctas;
  a.eps = eps;
  a.dtype = plan & 1;
  a.wdtype = (plan >> 1) & 1;
  a.vec = (plan >> 2) & 15;
  a.k = (plan >> 6) & 63;
  a.cluster = (plan >> 12) & 15;
  a.threads = (plan >> 16) & 2047;
  a.warp_rows = (plan >> 27) & 1;
  a.depth = (plan >> 28) & 3;
  return static_cast<int>(
      repro::launch_rmsnorm_bwd(a, static_cast<cudaStream_t>(stream)));
}

int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* o, void* scratch, void* lse, int B, int Sq,
                          int Sk, int H, int Hkv, int D, int Dv,
                          int q_offset, int kv_valid, int window, int causal,
                          float scale, int n_split, int dtype, void* stream) {
  repro::AttnArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.scratch = static_cast<float*>(scratch);
  a.lse = static_cast<float*>(lse);
  a.B = B;
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.Hkv = Hkv;
  a.D = D;
  a.Dv = Dv;
  a.q_offset = q_offset;
  a.kv_valid = kv_valid;
  a.window = window;
  a.causal = causal;
  a.scale = scale;
  a.n_split = n_split;
  return static_cast<int>(repro::launch_flash_attention(
      a, dtype, static_cast<cudaStream_t>(stream)));
}

int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const void* lse, void* delta, void* dq,
                              void* dk, void* dv, int B, int Sq, int Sk,
                              int H, int Hkv, int D, int Dv, int window,
                              int causal, float scale, int dtype,
                              void* stream) {
  repro::AttnBwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.B = B;
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.Hkv = Hkv;
  a.D = D;
  a.Dv = Dv;
  a.window = window;
  a.causal = causal;
  a.scale = scale;
  return static_cast<int>(repro::launch_flash_attention_bwd(
      a, dtype, static_cast<cudaStream_t>(stream)));
}

int repro_ssd_scan(const void* x, const void* dt, const void* a_rate,
                   const void* b, const void* c, const void* init, void* y,
                   void* state, void* scratch, int B, int S, int H, int P,
                   int N, int L, int scan_ctas, int dtype, void* stream) {
  repro::SsdArgs a;
  a.x = x;
  a.dt = dt;
  a.a = static_cast<const float*>(a_rate);
  a.b = b;
  a.c = c;
  a.init = static_cast<const float*>(init);
  a.y = static_cast<float*>(y);
  a.state = static_cast<float*>(state);
  a.scratch = static_cast<float*>(scratch);
  a.B = B;
  a.S = S;
  a.H = H;
  a.P = P;
  a.N = N;
  a.L = L;
  a.scan_ctas = scan_ctas;
  return static_cast<int>(repro::launch_ssd_scan(
      a, dtype, static_cast<cudaStream_t>(stream)));
}

int repro_ssd_scan_bwd(const void* x, const void* dt, const void* a_rate,
                       const void* b, const void* c, const void* dy,
                       const void* dstate, const void* states, void* dx,
                       void* ddt, void* db, void* dc, void* da, void* dinit,
                       void* scratch, int B, int S, int H, int P, int N,
                       int L, int groups, int dtype, void* stream) {
  repro::SsdBwdArgs a;
  a.x = x;
  a.dt = dt;
  a.a = static_cast<const float*>(a_rate);
  a.b = b;
  a.c = c;
  a.dy = static_cast<const float*>(dy);
  a.dstate = static_cast<const float*>(dstate);
  a.states = static_cast<const float*>(states);
  a.dx = dx;
  a.ddt = ddt;
  a.db = db;
  a.dc = dc;
  a.da = static_cast<float*>(da);
  a.dinit = static_cast<float*>(dinit);
  a.scratch = static_cast<float*>(scratch);
  a.B = B;
  a.S = S;
  a.H = H;
  a.P = P;
  a.N = N;
  a.L = L;
  a.groups = groups;
  return static_cast<int>(repro::launch_ssd_scan_bwd(
      a, dtype, static_cast<cudaStream_t>(stream)));
}

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

namespace {

// P for a pointer parameter, I for an int, F for a float, ? for anything
// else.
template <typename T>
constexpr char param_code() {
  return std::is_pointer<T>::value       ? 'P'
         : std::is_same<T, int>::value   ? 'I'
         : std::is_same<T, float>::value ? 'F'
                                         : '?';
}

// Writes "name=<one code per parameter>;" at `out`; returns its end.
template <typename R, typename... A>
char* append_signature(char* out, const char* name, R (*)(A...)) {
  while (*name) *out++ = *name++;
  *out++ = '=';
  const char codes[] = {param_code<A>()..., ';'};
  for (char c : codes) *out++ = c;
  return out;
}

struct Abi {
  char text[640];
};

Abi make_abi() {
  Abi abi{};
  char* out = append_signature(abi.text, "repro_schedule_tick",
                               &repro_schedule_tick);
  out = append_signature(out, "repro_waterfill", &repro_waterfill);
  out = append_signature(out, "repro_rmsnorm", &repro_rmsnorm);
  out = append_signature(out, "repro_rmsnorm_bwd", &repro_rmsnorm_bwd);
  out = append_signature(out, "repro_flash_attention",
                         &repro_flash_attention);
  out = append_signature(out, "repro_flash_attention_bwd",
                         &repro_flash_attention_bwd);
  out = append_signature(out, "repro_ssd_scan", &repro_ssd_scan);
  out = append_signature(out, "repro_ssd_scan_bwd", &repro_ssd_scan_bwd);
  *out = '\0';
  return abi;
}

}  // namespace

extern "C" const char* repro_abi() {
  static const Abi abi = make_abi();
  return abi.text;
}
