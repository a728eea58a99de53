// Semi-implicit vertical solve (sim1), one block per tile of columns with the
// Thomas recurrence as the only serial part: backward Euler (a_imp = 1,
// pace_sim1_*) or the θ-blend of any other implicitness weight θ = a_imp
// (pace_sim1_blend_*), each its own instantiation of the kernel.
//
// Replaces pace_tpu/ops/sim1_pallas.py `_sim1_kernel` (pallas_call at :181,
// entry sim1_solver_pallas :144). From the layer fields w, delz (< 0), pt,
// delp, pkz (S, K, Y, X) and the surface velocity ws (S, Y, X) it computes,
// in the operation order of ops/nonhydro.py sim1_solver and _p_fac_floor:
//   dm = delp / grav, t_v = pt pkz, p_full = dm rdgas t_v / (-delz)
//   p_hyd = delp / (ln pe_below - ln pe_above), pe = ptop + running sum of
//           delp, floored at 1e-10 under the log
//   pprime = p_full - p_hyd,  B = -gamma p_full dt / delz  (> 0)
//   the tridiagonal for the interface velocities W_0..W_{K-1} (W_K = ws folded
//   into the last row), solved by the Thomas algorithm
//   with θ != 1, the implicit coupling scaled by θ² and the explicit term
//   θ(1-θ) r δ(B ΔW0) on the right-hand side (W0 the interface velocities of
//   the input w, ΔW0 their difference across each layer), and the blended
//   dW = θ dW + (1-θ) ΔW0 in the updates below
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
// Design: a block owns TC consecutive columns of one shard's plane and all K
// levels (TC = 16 for float at K = 79, fewer where K or the type ask more
// shared memory: `tile_columns` below). Everything but the running sum of
// delp and the Thomas recurrence is parallel over levels, so it is spread
// over the block's 256 threads in passes over [level][column] arrays in
// shared memory (a warp's lanes on consecutive columns of a level: every
// global access is a run of consecutive columns):
//   A0  all five inputs (and ws) arrive by cp.async, all in flight at once
//   A1  dm, gas = dm rdgas t_v, p_full, B (warps 1..), while
//   A2  one thread per column of warp 0 forms the running sum of delp
//   A3  the logs of the interface pressures, in place
//   A4  p_hyd, pprime, the floor, r = dt / dmh
//   A5  each row's diagonal and right-hand side (with w0)
//   B   one thread per column of warp 0: the elimination, whose chain is
//       the two divisions by denom a level (the next level's operands are
//       read ahead), and the substitution; meanwhile warps 1.. fetch delz
//       again (from L2)
//   C1  delz_new with its floor, pprime_new
//   C2  pp at the K + 1 interfaces, while w is fetched again
//   C3  w_new
// The θ-blend adds one pass after B: ΔW0 into s_dz (the diagonal is dead
// there), from w, which B then leaves in s_w; delz is fetched after it.
// The serial phase B runs on TC lanes while the rest of the block waits, so it
// does the recurrence and nothing else. No pass waits on a load from device
// memory. Eight arrays of
// K x TC values, each reused as its contents die:
//   s_w   w -> delz -> w           s_g   pt -> gas -> floor limit
//   s_dz  delz -> diagonal         s_dm  dm
//   s_dp  delp -> r -> cp -> pp    s_b   B
//   s_pf  pkz -> p_full -> pprime -> pprime_new
//   s_ln  acc -> ln pe -> right-hand side -> dv -> W
// No index depends on the data, so columns of non-finite ghost values cannot
// fault; the ragged last tile's missing columns are neither loaded nor
// stored.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kArrays = 8;
// blocks an SM the registers are budgeted for (64 a thread)
constexpr int kBlocksPerSM = 4;

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
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
               "n"(sizeof(T)));
}

__device__ __forceinline__ void cp_async_join() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
}

// Grid: x = shard * tiles + tile; TC columns a tile (a power of two up to
// 32), K levels. A thread keeps one column c = tid % TC in every pass and
// takes the levels k = tid / TC, + kThreads / TC, ...: no division in the
// passes' index arithmetic.
// Blend: the θ-blend, with th2 = θ², th1 = θ(1-θ), theta = θ and omt = 1-θ
// (each rounded from double, as the plain version's Python scalars are).
template <typename T, bool Blend>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) sim1_kernel(
    const T* __restrict__ w_in, const T* __restrict__ delz_in,
    const T* __restrict__ pt_in, const T* __restrict__ delp_in,
    const T* __restrict__ pkz_in, const T* __restrict__ ws_in, T dt, T ptop,
    T p_fac, T grav, T rdgas, T gamma, T th2, T th1, T theta, T omt,
    T* __restrict__ w_out, T* __restrict__ dz_out, T* __restrict__ pp_out,
    int K, int P, int TC) {
  extern __shared__ unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const int KT = K * TC;
  T* const s_w = sm;
  T* const s_dz = sm + KT;
  T* const s_dp = sm + 2 * KT;
  T* const s_g = sm + 3 * KT;
  T* const s_pf = sm + 4 * KT;
  T* const s_dm = sm + 5 * KT;
  T* const s_b = sm + 6 * KT;
  T* const s_ln = sm + 7 * KT;
  T* const s_ws = sm + kArrays * KT;

  const int tiles = (P + TC - 1) / TC;
  const int s = blockIdx.x / tiles;
  const int p0 = (blockIdx.x - s * tiles) * TC;
  const int nc = P - p0 < TC ? P - p0 : TC;  // columns of this tile
  const int tid = threadIdx.x;
  const int c = tid % TC;               // this thread's column in every pass
  const bool col = c < nc;
  const int k0 = tid / TC;              // its first level
  const int dk = kThreads / TC;         // its level step
  const long long g0 = (long long)s * K * P + p0 + c;  // level 0 of its column
  const T eps = T(1e-10);

  // A0: every input, by cp.async, all in flight at once
  if (col) {
    for (int k = k0; k < K; k += dk) {
      const int e = k * TC + c;
      const long long g = g0 + (long long)k * P;
      cp_async(s_w + e, w_in + g);
      cp_async(s_dz + e, delz_in + g);
      cp_async(s_dp + e, delp_in + g);
      cp_async(s_g + e, pt_in + g);
      cp_async(s_pf + e, pkz_in + g);
    }
    if (k0 == 0) cp_async(s_ws + c, ws_in + (long long)s * P + p0 + c);
  }
  cp_async_join();

  // A1 (warps 1..): the terms of each layer
  if (tid >= 32 && col) {
    for (int k = (tid - 32) / TC; k < K; k += (kThreads - 32) / TC) {
      const int e = k * TC + c;
      const T delp = s_dp[e], delz = s_dz[e];
      const T dm = delp / grav;
      const T t_v = s_g[e] * s_pf[e];
      const T gas = dm * rdgas * t_v;
      const T p_full = gas / (-delz);
      s_dm[e] = dm;
      s_g[e] = gas;
      s_pf[e] = p_full;
      s_b[e] = -gamma * p_full * dt / delz;
    }
  }
  // A2 (warp 0, beside A1): the running sum of delp, one thread per column
  // (A1 writes neither s_ln nor s_dp)
  if (tid < nc) {
    T acc = T(0);
    T d = s_dp[tid];
    for (int k = 0; k < K; ++k) {
      const T d_next = k + 1 < K ? s_dp[(k + 1) * TC + tid] : T(0);
      acc = acc + d;
      s_ln[k * TC + tid] = acc;
      d = d_next;
    }
  }
  __syncthreads();

  // A3: ln of the interface pressures below each layer
  if (col) {
    for (int k = k0; k < K; k += dk) {
      const int e = k * TC + c;
      s_ln[e] = vlog<T>(vmax<T>(ptop + s_ln[e], eps));
    }
  }
  __syncthreads();

  // A4: hydrostatic layer pressure, pprime, the floor, and r = dt / dmh over
  // delp (each level reads only its own delp)
  const T ln_top = vlog<T>(vmax<T>(ptop, eps));
  if (col) {
    for (int k = k0; k < K; k += dk) {
      const int e = k * TC + c;
      const T ln_above = k > 0 ? s_ln[e - TC] : ln_top;
      const T p_hyd = s_dp[e] / (s_ln[e] - ln_above);
      s_pf[e] = s_pf[e] - p_hyd;
      if (p_fac > T(0)) s_g[e] = -(s_g[e] / (p_fac * p_hyd));
      const T dm = s_dm[e];
      const T dmh = k == 0 ? T(0.5) * dm : T(0.5) * (s_dm[e - TC] + dm);
      s_dp[e] = dt / dmh;
    }
  }
  __syncthreads();

  // A5: each row's diagonal (over delz) and right-hand side (over ln); the
  // known W_K = ws goes to the last row's right-hand side
  if (col) {
    for (int k = k0; k < K; k += dk) {
      const int e = k * TC + c;
      const T r = s_dp[e], b = s_b[e], w = s_w[e], dm = s_dm[e], pprime = s_pf[e];
      T b_up = T(0), pprime_up = T(0), w0 = w;
      if (k > 0) {
        const T dm_up = s_dm[e - TC];
        b_up = s_b[e - TC];
        pprime_up = s_pf[e - TC];
        w0 = (dm * s_w[e - TC] + dm_up * w) / (dm_up + dm);
      }
      T rhs = w0 + r * (pprime - pprime_up);
      if (Blend) {
        // W0 of the interface below (ws at the bottom) and above this row
        T w0_dn = s_ws[c];
        if (k + 1 < K) {
          const T dm_dn = s_dm[e + TC];
          w0_dn = (dm_dn * w + dm * s_w[e + TC]) / (dm + dm_dn);
        }
        T bdw0_up = T(0);
        if (k > 0) {
          T w0_up = s_w[e - TC];
          if (k > 1) {
            const T dm_up = s_dm[e - TC], dm_up2 = s_dm[e - 2 * TC];
            w0_up = (dm_up * s_w[e - 2 * TC] + dm_up2 * s_w[e - TC]) / (dm_up2 + dm_up);
          }
          bdw0_up = b_up * (w0 - w0_up);
        }
        rhs = rhs + (th1 * r) * (b * (w0_dn - w0) - bdw0_up);
        if (k == K - 1) rhs = rhs + (-((-th2 * r) * b) * s_ws[c]);
        s_dz[e] = T(1) + (th2 * r) * (b_up + b);
      } else {
        if (k == K - 1) rhs = rhs + (-(-r * b) * s_ws[c]);
        s_dz[e] = T(1) + r * (b_up + b);
      }
      s_ln[e] = rhs;
    }
  }
  __syncthreads();

  // B: the Thomas recurrence, one thread per column (warp 0): the
  // elimination, whose chain is the two divisions by denom a level (the
  // next level's operands are read ahead), then the substitution. cp goes
  // over r, dv and then W over the right-hand side. Meanwhile warps 1..
  // fetch delz again into s_w (w is done with; from L2).
  if (tid < nc) {
    T cp = T(0), dv = T(0), b_up = T(0);
    int e = tid;
    T r = s_dp[e], b = s_b[e], b_d = s_dz[e], rhs = s_ln[e];
    for (int k = 0; k < K; ++k, e += TC) {
      T r_n = T(0), b_n = T(0), bd_n = T(0), rhs_n = T(0);
      if (k + 1 < K) {
        r_n = s_dp[e + TC];
        b_n = s_b[e + TC];
        bd_n = s_dz[e + TC];
        rhs_n = s_ln[e + TC];
      }
      const T rc = Blend ? -th2 * r : -r;
      const T a_d = rc * b_up;
      const T c_d = k == K - 1 ? T(0) : rc * b;
      const T denom = b_d - a_d * cp;
      cp = c_d / denom;
      dv = (rhs - a_d * dv) / denom;
      s_dp[e] = cp;
      s_ln[e] = dv;
      b_up = b;
      r = r_n;
      b = b_n;
      b_d = bd_n;
      rhs = rhs_n;
    }
    e = (K - 1) * TC + tid;
    T x_dn = T(0);
    T dv_k = s_ln[e], cp_k = s_dp[e];
    for (int k = K - 1; k >= 0; --k, e -= TC) {
      T dv_n = T(0), cp_n = T(0);
      if (k > 0) {
        dv_n = s_ln[e - TC];
        cp_n = s_dp[e - TC];
      }
      const T x = dv_k - cp_k * x_dn;
      s_ln[e] = x;
      x_dn = x;
      dv_k = dv_n;
      cp_k = cp_n;
    }
  } else if (!Blend && tid >= 32 && col) {
    for (int k = (tid - 32) / TC; k < K; k += (kThreads - 32) / TC)
      cp_async(s_w + k * TC + c, delz_in + g0 + (long long)k * P);
  }
  cp_async_join();

  // the θ-blend: ΔW0 of each layer into s_dz, then delz into s_w
  if (Blend) {
    if (col) {
      for (int k = k0; k < K; k += dk) {
        const int e = k * TC + c;
        const T w = s_w[e], dm = s_dm[e];
        T w0 = w, w0_dn = s_ws[c];
        if (k > 0) {
          const T dm_up = s_dm[e - TC];
          w0 = (dm * s_w[e - TC] + dm_up * w) / (dm_up + dm);
        }
        if (k + 1 < K) {
          const T dm_dn = s_dm[e + TC];
          w0_dn = (dm_dn * w + dm * s_w[e + TC]) / (dm + dm_dn);
        }
        s_dz[e] = w0_dn - w0;
      }
    }
    __syncthreads();
    if (col) {
      for (int k = k0; k < K; k += dk)
        cp_async(s_w + k * TC + c, delz_in + g0 + (long long)k * P);
    }
    cp_async_join();
  }

  // C1: the thicknesses with their floor, the new layer pprime
  if (col) {
    for (int k = k0; k < K; k += dk) {
      const int e = k * TC + c;
      const T x_dn = k < K - 1 ? s_ln[e + TC] : s_ws[c];
      T dwdz = x_dn - s_ln[e];
      if (Blend) dwdz = theta * dwdz + omt * s_dz[e];
      T dz_new = s_w[e] + dt * dwdz;
      if (p_fac > T(0)) dz_new = vmax<T>(dz_new, s_g[e]);
      dz_out[g0 + (long long)k * P] = dz_new;
      s_pf[e] = s_pf[e] + s_b[e] * dwdz;
    }
  }
  __syncthreads();

  // C2: w fetched again into s_w while pp is formed at interfaces 0..K
  // (interface i between layers i-1 and i); pp[i] for i >= 1 also goes to
  // s_dp row i-1
  const long long g1 = (long long)s * (K + 1) * P + p0 + c;
  if (col) {
    for (int k = k0; k < K; k += dk) cp_async(s_w + k * TC + c, w_in + g0 + (long long)k * P);
    for (int i = k0; i <= K; i += dk) {
      T pp;
      if (i == 0) {
        pp = T(0);
      } else {
        const int m = (i - 1) * TC + c;  // layer i-1
        if (i == K) {
          pp = T(1.5) * s_pf[m] - T(0.5) * s_pf[m - TC];
        } else {
          const T dm_up = s_dm[m], dm_dn = s_dm[m + TC];
          pp = (dm_dn * s_pf[m] + dm_up * s_pf[m + TC]) / (dm_up + dm_dn);
        }
        s_dp[m] = pp;
      }
      pp_out[g1 + (long long)i * P] = pp;
    }
  }
  cp_async_join();

  // C3: layer w from the interface pressure differences
  if (col) {
    for (int k = k0; k < K; k += dk) {
      const int e = k * TC + c;
      const T pp_up = k > 0 ? s_dp[e - TC] : T(0);
      w_out[g0 + (long long)k * P] = s_w[e] + (dt / s_dm[e]) * (s_dp[e] - pp_up);
    }
  }
}

// Columns a block: the widest of 32, 16, ..., 1 whose kArrays K values and
// one surface value a column fit in a quarter of an SM's shared memory
// (kBlocksPerSM blocks an SM: 228 KB less 1 KB reserved a block), one column
// up to a block's 227 KB; 0 where even that does not fit. ops/sim1_kernel.py
// tile_columns states the same rule.
constexpr long long kSmemPerBlock = 57344;
constexpr long long kSmemMax = 232448;

int tile_columns(int K, int elem) {
  const long long per_col = ((long long)kArrays * K + 1) * elem;
  int tc = 32;
  while (tc > 1 && tc * per_col > kSmemPerBlock) tc /= 2;
  return tc * per_col > kSmemMax ? 0 : tc;
}

template <typename T, bool Blend>
int launch(const void* w, const void* delz, const void* pt, const void* delp,
           const void* pkz, const void* ws, double dt, double ptop, double p_fac,
           double grav, double rdgas, double gamma, double a_imp, void* w_out,
           void* dz_out, void* pp, int S, int K, int P, void* stream) {
  const int TC = tile_columns(K, (int)sizeof(T));
  if (K < 2 || TC < 1) return -1;
  const size_t smem = sizeof(T) * ((size_t)kArrays * K + 1) * TC;
  auto kern = sim1_kernel<T, Blend>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (P + TC - 1) / TC;
  kern<<<(unsigned)(S * tiles), kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)w, (const T*)delz, (const T*)pt, (const T*)delp, (const T*)pkz,
      (const T*)ws, (T)dt, (T)ptop, (T)p_fac, (T)grav, (T)rdgas, (T)gamma,
      (T)(a_imp * a_imp), (T)(a_imp * (1.0 - a_imp)), (T)a_imp, (T)(1.0 - a_imp),
      (T*)w_out, (T*)dz_out, (T*)pp, K, P, TC);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pace_sim1_f32(const void* w, const void* delz, const void* pt,
                             const void* delp, const void* pkz, const void* ws,
                             double dt, double ptop, double p_fac, double grav,
                             double rdgas, double gamma, void* w_out,
                             void* dz_out, void* pp, int S, int K, int P,
                             void* stream) {
  return launch<float, false>(w, delz, pt, delp, pkz, ws, dt, ptop, p_fac, grav,
                              rdgas, gamma, 1.0, w_out, dz_out, pp, S, K, P, stream);
}

extern "C" int pace_sim1_f64(const void* w, const void* delz, const void* pt,
                             const void* delp, const void* pkz, const void* ws,
                             double dt, double ptop, double p_fac, double grav,
                             double rdgas, double gamma, void* w_out,
                             void* dz_out, void* pp, int S, int K, int P,
                             void* stream) {
  return launch<double, false>(w, delz, pt, delp, pkz, ws, dt, ptop, p_fac, grav,
                               rdgas, gamma, 1.0, w_out, dz_out, pp, S, K, P, stream);
}

// The θ-blend, a_imp = θ != 1: the arguments of pace_sim1_* with a_imp
// before w_out.
extern "C" int pace_sim1_blend_f32(const void* w, const void* delz, const void* pt,
                                   const void* delp, const void* pkz, const void* ws,
                                   double dt, double ptop, double p_fac, double grav,
                                   double rdgas, double gamma, double a_imp,
                                   void* w_out, void* dz_out, void* pp, int S, int K,
                                   int P, void* stream) {
  return launch<float, true>(w, delz, pt, delp, pkz, ws, dt, ptop, p_fac, grav, rdgas,
                             gamma, a_imp, w_out, dz_out, pp, S, K, P, stream);
}

extern "C" int pace_sim1_blend_f64(const void* w, const void* delz, const void* pt,
                                   const void* delp, const void* pkz, const void* ws,
                                   double dt, double ptop, double p_fac, double grav,
                                   double rdgas, double gamma, double a_imp,
                                   void* w_out, void* dz_out, void* pp, int S, int K,
                                   int P, void* stream) {
  return launch<double, true>(w, delz, pt, delp, pkz, ws, dt, ptop, p_fac, grav, rdgas,
                              gamma, a_imp, w_out, dz_out, pp, S, K, P, stream);
}
