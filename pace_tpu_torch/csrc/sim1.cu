// Semi-implicit vertical solve (sim1), backward-Euler, one thread per column.
//
// Replaces pace_tpu/ops/sim1_pallas.py `_sim1_kernel` (pallas_call at :181,
// entry sim1_solver_pallas :144). From the layer fields w, delz (< 0), pt,
// delp, pkz (S, K, Y, X) and the surface velocity ws (S, Y, X) it computes,
// in the operation order of ops/nonhydro.py sim1_solver (a_imp = 1) and
// _p_fac_floor:
//   dm = delp / grav, t_v = pt pkz, p_full = dm rdgas t_v / (-delz)
//   p_hyd = delp / (ln pe_below - ln pe_above), pe = ptop + running sum of
//           delp, floored at 1e-10 under the log
//   pprime = p_full - p_hyd,  B = -gamma p_full dt / delz  (> 0)
//   the tridiagonal for the interface velocities W_0..W_{K-1} (W_K = ws folded
//   into the last row), solved by the Thomas algorithm
//   delz_new = max(delz + dt dW, -dm rdgas t_v / (p_fac p_hyd))  (p_fac > 0)
//   pprime_new = pprime + B dW
//   pp[0] = 0, mass-weighted interior interfaces, pp[K] = 1.5 pprime_new[K-1]
//           - 0.5 pprime_new[K-2]
//   w_new = w + (dt / dm) (pp[k+1] - pp[k])
// and writes w_new, delz_new (S, K, Y, X) and pp (S, K+1, Y, X).
//
// Bound on an H100: bytes (five fields read, three written, ~0.6 GB, ~0.18 ms
// at 3.35 TB/s for a C192 npz=79 f32 call; about 60 operations, one log and
// 9 divisions per point are ~0.1 ms of arithmetic).
// Design: the backward sweep needs the forward sweep's cp[k], dp[k] and the
// hydrostatic layer pressure (its running sum cannot be walked back in the
// same rounding) of all K levels: 3 K values per column, too many for
// registers and, at a useful occupancy, for shared memory. They are parked in
// the output buffers (cp in w_new, dp in delz_new, p_hyd in pp[0..K-1]); each
// thread reads a slot back before it overwrites it with the result, so no
// other scratch exists. The backward sweep re-reads the five inputs and
// re-forms dm, t_v, p_full, pprime and B with the same operations. A thread
// owns column (s, y, x), x fastest: every load and store of a warp at one
// level is one 128-byte line. No index depends on the data, so columns of
// non-finite ghost values cannot fault.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <typename T>
__device__ __forceinline__ T vlog(T x);
template <>
__device__ __forceinline__ float vlog<float>(float x) { return logf(x); }
template <>
__device__ __forceinline__ double vlog<double>(double x) { return log(x); }

template <typename T>
__device__ __forceinline__ T vmax(T a, T b);
template <>
__device__ __forceinline__ float vmax<float>(float a, float b) { return fmaxf(a, b); }
template <>
__device__ __forceinline__ double vmax<double>(double a, double b) { return fmax(a, b); }

template <typename T>
__global__ void __launch_bounds__(kThreads) sim1_kernel(
    const T* __restrict__ w_in, const T* __restrict__ delz_in,
    const T* __restrict__ pt_in, const T* __restrict__ delp_in,
    const T* __restrict__ pkz_in, const T* __restrict__ ws_in, T dt, T ptop,
    T p_fac, T grav, T rdgas, T gamma, T* __restrict__ w_out,
    T* __restrict__ dz_out, T* __restrict__ pp_out, int S, int K, int P) {
  const long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (col >= (long long)S * P) return;
  const int s = (int)(col / P);
  const int p = (int)(col - (long long)s * P);
  const long long o0 = (long long)s * K * P + p;        // K-level fields
  const long long o1 = (long long)s * (K + 1) * P + p;  // pp
  const T* w_p = w_in + o0;
  const T* dz_p = delz_in + o0;
  const T* pt_p = pt_in + o0;
  const T* dp_p = delp_in + o0;
  const T* pkz_p = pkz_in + o0;
  T* cp_s = w_out + o0;    // forward: cp[k];    backward: w_new[k]
  T* dv_s = dz_out + o0;   // forward: dp[k];    backward: delz_new[k]
  T* pp_s = pp_out + o1;   // forward: p_hyd[k]; backward: pp[k]
  const T ws = ws_in[col];
  const T eps = T(1e-10);

  // ---- forward sweep: assemble row k from levels k-1 and k, eliminate
  T acc = T(0);
  T ln_above = vlog<T>(vmax<T>(ptop, eps));
  T dm_up = T(0), w_up = T(0), b_up = T(0), pprime_up = T(0);
  T cp = T(0), dv = T(0);
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const long long o = (long long)k * P;
    const T delp = dp_p[o], delz = dz_p[o], w = w_p[o];
    const T dm = delp / grav;
    const T t_v = pt_p[o] * pkz_p[o];
    const T p_full = dm * rdgas * t_v / (-delz);
    acc = acc + delp;
    const T ln_below = vlog<T>(vmax<T>(ptop + acc, eps));
    const T p_hyd = delp / (ln_below - ln_above);
    ln_above = ln_below;
    const T pprime = p_full - p_hyd;
    const T b = -gamma * p_full * dt / delz;
    T dmh, w0;
    if (k == 0) {
      dmh = T(0.5) * dm;
      w0 = w;
    } else {
      dmh = T(0.5) * (dm_up + dm);
      w0 = (dm * w_up + dm_up * w) / (dm_up + dm);
    }
    const T r = dt / dmh;
    const T a_d = -r * b_up;
    const T b_d = T(1) + r * (b_up + b);
    T c_d = -r * b;
    T rhs = w0 + r * (pprime - pprime_up);
    if (k == K - 1) {  // the known W_K = ws goes to the right-hand side
      rhs = rhs + (-c_d * ws);
      c_d = T(0);
    }
    const T denom = b_d - a_d * cp;
    cp = c_d / denom;
    dv = (rhs - a_d * dv) / denom;
    cp_s[o] = cp;
    dv_s[o] = dv;
    pp_s[o] = p_hyd;
    dm_up = dm; w_up = w; b_up = b; pprime_up = pprime;
  }

  // ---- backward sweep: substitute, update, interpolate pp, then w
  T x_dn = T(0);   // W_{k+1} of the substitution (the last row has c = 0)
  T wi_dn = ws;    // W_{k+1} of the divergence
  T dm_dn = T(0), w_dn = T(0), ppn_dn = T(0);  // level k+1
  T pp_dn2 = T(0);                             // pp[k+2]
  for (int k = K - 1; k >= 0; --k) {
    const long long o = (long long)k * P;
    const T cp_k = cp_s[o], dv_k = dv_s[o], p_hyd = pp_s[o];
    const T delp = dp_p[o], delz = dz_p[o], w = w_p[o];
    const T dm = delp / grav;
    const T t_v = pt_p[o] * pkz_p[o];
    const T gas = dm * rdgas * t_v;
    const T p_full = gas / (-delz);
    const T pprime = p_full - p_hyd;
    const T b = -gamma * p_full * dt / delz;
    const T x = dv_k - cp_k * x_dn;
    const T dwdz = wi_dn - x;
    T dz_new = delz + dt * dwdz;
    if (p_fac > T(0)) dz_new = vmax<T>(dz_new, -(gas / (p_fac * p_hyd)));
    dv_s[o] = dz_new;
    const T ppn = pprime + b * dwdz;
    if (k < K - 1) {
      // interface k+1 lies between layers k (above) and k+1 (below)
      const T pp_dn = (dm_dn * ppn + dm * ppn_dn) / (dm + dm_dn);
      if (k == K - 2) {
        pp_dn2 = T(1.5) * ppn_dn - T(0.5) * ppn;
        pp_s[o + 2 * (long long)P] = pp_dn2;
      }
      pp_s[o + P] = pp_dn;
      cp_s[o + P] = w_dn + (dt / dm_dn) * (pp_dn2 - pp_dn);
      pp_dn2 = pp_dn;
    }
    x_dn = x; wi_dn = x;
    dm_dn = dm; w_dn = w; ppn_dn = ppn;
  }
  pp_s[0] = T(0);
  cp_s[0] = w_dn + (dt / dm_dn) * (pp_dn2 - T(0));
}

template <typename T>
int launch(const void* w, const void* delz, const void* pt, const void* delp,
           const void* pkz, const void* ws, double dt, double ptop, double p_fac,
           double grav, double rdgas, double gamma, void* w_out, void* dz_out,
           void* pp, int S, int K, int P, void* stream) {
  const long long cols = (long long)S * P;
  const unsigned blocks = (unsigned)((cols + kThreads - 1) / kThreads);
  sim1_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)w, (const T*)delz, (const T*)pt, (const T*)delp, (const T*)pkz,
      (const T*)ws, (T)dt, (T)ptop, (T)p_fac, (T)grav, (T)rdgas, (T)gamma,
      (T*)w_out, (T*)dz_out, (T*)pp, S, K, P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pace_sim1_f32(const void* w, const void* delz, const void* pt,
                             const void* delp, const void* pkz, const void* ws,
                             double dt, double ptop, double p_fac, double grav,
                             double rdgas, double gamma, void* w_out,
                             void* dz_out, void* pp, int S, int K, int P,
                             void* stream) {
  return launch<float>(w, delz, pt, delp, pkz, ws, dt, ptop, p_fac, grav, rdgas,
                       gamma, w_out, dz_out, pp, S, K, P, stream);
}

extern "C" int pace_sim1_f64(const void* w, const void* delz, const void* pt,
                             const void* delp, const void* pkz, const void* ws,
                             double dt, double ptop, double p_fac, double grav,
                             double rdgas, double gamma, void* w_out,
                             void* dz_out, void* pp, int S, int K, int P,
                             void* stream) {
  return launch<double>(w, delz, pt, delp, pkz, ws, dt, ptop, p_fac, grav, rdgas,
                        gamma, w_out, dz_out, pp, S, K, P, stream);
}
