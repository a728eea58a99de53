// Lin & Rood (1996) 2-D PPM flux-form transport, fused in one kernel.
//
// Replaces pace_tpu/ops/fvtp2d_pallas.py `_kernel` (pallas_call at :212,
// entry fvtp2d_pallas :229) and `_kernel_tracer` (pallas_call at :501,
// entry fvtp2d_tracer_pallas :519): the single-field kernel is this one
// with NQ = 1 (mass-flux weights on or off), the tracer kernel runs a
// stacked block of NQ tracers that share the Courant numbers, area fluxes,
// cell areas and mass fluxes. fvtp2d_multi_kernel, further down, replaces
// `_kernel_multi` (pallas_call at :390, entry fvtp2d_multi_pallas :578):
// up to four separate fields, each with its own hord, weighting and y-fold
// form, in one launch.
//
//     Fx = 1/2 [ X(q) + X(Y(q)) ] * wx        Fy = 1/2 [ Y(q) + Y(X(q)) ] * wy
//
// X/Y are 1-D PPM interface values (pace_tpu_torch/ops/ppm.py, hord 1, 5,
// 6, 7, 8); Y(q)/X(q) are the inner flux-form updates divided by the updated
// area. Arithmetic follows ppm.py and fvtp2d.py op for op; built with
// -fmad=false it rounds like the plain PyTorch version.
//
// Layout: cell-aligned. Interface i of an x-interface array (Y, X+1) sits
// at cell slot i; all stencil reads wrap modulo (Y, X), like the rolls of
// the plain version, and the never-consumed outermost interface column of
// fx (row of fy) is written as zero, as the TPU kernel does.
//
// Bound on an H100: bytes. The scheme needs ~156 flops per output point
// (hord 8, per-cell PPM terms counted once; four 1-D PPM evaluations, two
// inner updates), ~0.04 ms at the 67 TFLOP/s f32 rate for a C192 npz=79
// field against ~0.16 ms for its ~520 MB of operand and result traffic at
// 3.35 TB/s. This kernel recomputes the per-cell dm/al terms for each
// interface it evaluates (about 2.5x the needed flops at hord 8).
// Design: one thread block per (output tile, level, shard, tracer) stages
// q, the y-fold corner pack, crx/cry/xfx/yfx/area with a 3-cell stencil
// halo in shared memory
// and keeps every intermediate (the inner fluxes fx1/fy1 and the inner
// updates, written in place over the staged q) there: device memory sees
// one read of each operand tile (plus the halo overlap, 1.7x at 16x32) and
// one write of fx and fy. Tracers of one (tile, level) run in consecutive
// blocks so the shared operands are served from L2 after the first.

#include <cuda_runtime.h>

namespace {

constexpr int R = 3;  // one PPM sweep: interface i reads cells i-3 .. i+2
constexpr int TY = 16;
constexpr int TX = 32;
constexpr int SY = TY + 2 * R;
constexpr int SX = TX + 2 * R;
constexpr int NS = SY * SX;  // staged points per array
constexpr int kArrays = 9;   // qx, qy, crx, cry, xfx, yfx, area, fx1, fy1
constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ T vmin(T a, T b) { return a < b ? a : b; }
template <typename T>
__device__ __forceinline__ T vmax(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T vabs(T a) { return a < T(0) ? -a : a; }

// hord 7: positive-definite constraint (ppm._positive_limit)
template <typename T>
__device__ __forceinline__ T vertex_min(T bl, T br, T aL) {
  const T da = br - bl;
  const T a6 = T(-3.0) * (bl + br);
  const bool has_vertex = vabs(da) < vabs(a6);
  const T safe = (a6 == T(0)) ? T(1e-30) : a6;
  const T t = da + a6;
  const T pv = aL + (t * t) / (T(4.0) * safe);
  return has_vertex ? pv : aL;
}

template <typename T>
__device__ __forceinline__ void positive_limit(T q, T& bl, T& br) {
  const T aL = q + bl;
  const T aR = q + br;
  const T pmin = vmin(vmin(aL, aR), vertex_min(bl, br, aL));
  const bool need = pmin < T(0);
  T bl1 = vmax(bl, -q);
  T br1 = vmax(br, -q);
  const bool still_neg = vertex_min(bl1, br1, q + bl1) < T(0);
  if (still_neg) { bl1 = T(0); br1 = T(0); }
  if (need) { bl = bl1; br = br1; }
}

// hord 8: mono slope (ppm._dm_mono)
template <typename T>
__device__ __forceinline__ T dm_mono(T qm, T q, T qp) {
  const T xt = T(0.5) * (qp - qm);
  const T q_hi = vmax(vmax(qm, q), qp) - q;
  const T q_lo = q - vmin(vmin(qm, q), qp);
  const T lim = vmin(vabs(xt), vmin(q_hi, q_lo));
  return xt >= T(0) ? lim : -lim;
}

// hord 8 interface perturbations of one cell (ppm._perturbations_mono)
template <typename T>
__device__ __forceinline__ void mono_b(T q, T dm, T al, T al_next, T& bl, T& br) {
  const T xt2 = T(2.0) * dm;
  const T axt = vabs(xt2);
  const T blm = vmin(axt, vabs(al - q));
  const T brm = vmin(axt, vabs(al_next - q));
  bl = xt2 >= T(0) ? -blm : blm;
  br = xt2 >= T(0) ? brm : -brm;
}

// Interface value of the upstream PPM profile mean (ppm._flux_1d) at the
// interface between cells a = q[-1] and b = q[0]; q[-3..2] given.
template <typename T, int HORD>
__device__ __forceinline__ T flux_1d(T qm3, T qm2, T qm1, T q0, T qp1, T qp2, T c) {
  if constexpr (HORD == 1) {
    return c > T(0) ? qm1 : q0;
  } else {
  T bl_m1, br_m1, bl_0, br_0;
  if constexpr (HORD == 8) {
    const T c3 = T(1.0 / 3.0);
    const T dm_m2 = dm_mono(qm3, qm2, qm1);
    const T dm_m1 = dm_mono(qm2, qm1, q0);
    const T dm_0 = dm_mono(qm1, q0, qp1);
    const T dm_p1 = dm_mono(q0, qp1, qp2);
    const T al_m1 = T(0.5) * (qm2 + qm1) + c3 * (dm_m2 - dm_m1);
    const T al_0 = T(0.5) * (qm1 + q0) + c3 * (dm_m1 - dm_0);
    const T al_p1 = T(0.5) * (q0 + qp1) + c3 * (dm_0 - dm_p1);
    mono_b(qm1, dm_m1, al_m1, al_0, bl_m1, br_m1);
    mono_b(q0, dm_0, al_0, al_p1, bl_0, br_0);
  } else {
    const T c7 = T(7.0 / 12.0);
    const T c1 = T(1.0 / 12.0);
    const T al_m1 = c7 * (qm2 + qm1) - c1 * (qm3 + q0);
    const T al_0 = c7 * (qm1 + q0) - c1 * (qm2 + qp1);
    const T al_p1 = c7 * (q0 + qp1) - c1 * (qm1 + qp2);
    bl_m1 = al_m1 - qm1;
    br_m1 = al_0 - qm1;
    bl_0 = al_0 - q0;
    br_0 = al_p1 - q0;
    if constexpr (HORD == 7) {
      positive_limit(qm1, bl_m1, br_m1);
      positive_limit(q0, bl_0, br_0);
    }
  }
  const T b0_m1 = bl_m1 + br_m1;
  const T b0_0 = bl_0 + br_0;
  const T f_pos = qm1 + (T(1.0) - c) * (br_m1 - c * b0_m1);
  const T f_neg = q0 + (T(1.0) + c) * (bl_0 + c * b0_0);
  return c > T(0) ? f_pos : f_neg;
  }
}

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// Grid: x = tile * NQ + tracer, y = level, z = shard.
// qy_mode 0: qy is a full (S, NQ, K, Y, X) array; 1: qy is the y-fold
// corner pack (S, NQ, K, 2h, 2h) applied over qx ([[SW, SE], [NW, NE]]).
template <typename T, int HORD>
__global__ void __launch_bounds__(kThreads) fvtp2d_kernel(
    const T* __restrict__ qx, const T* __restrict__ qy, int qy_mode, int h,
    const T* __restrict__ crx, const T* __restrict__ cry,
    const T* __restrict__ xfx, const T* __restrict__ yfx,
    const T* __restrict__ area, const T* __restrict__ mfx,
    const T* __restrict__ mfy, T* __restrict__ fx, T* __restrict__ fy,
    int NQ, int K, int Y, int X) {
  extern __shared__ unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* s_qx = sm;  // later overwritten by the inner update q_j
  T* s_qy = sm + NS;  // later overwritten by the inner update q_i
  T* s_crx = sm + 2 * NS;
  T* s_cry = sm + 3 * NS;
  T* s_xfx = sm + 4 * NS;
  T* s_yfx = sm + 5 * NS;
  T* s_area = sm + 6 * NS;
  T* s_fx1 = sm + 7 * NS;
  T* s_fy1 = sm + 8 * NS;

  const int tiles_x = (X + TX - 1) / TX;
  const int tile = blockIdx.x / NQ;
  const int t = blockIdx.x - tile * NQ;
  const int j0 = (tile / tiles_x) * TY;
  const int i0 = (tile - (tile / tiles_x) * tiles_x) * TX;
  const int k = blockIdx.y;
  const int s = blockIdx.z;
  const int X1 = X + 1;
  const int Y1 = Y + 1;

  const long long qlev = ((long long)(s * NQ + t) * K + k);
  const long long oplev = (long long)s * K + k;
  const T* qx_p = qx + qlev * Y * X;
  const T* crx_p = crx + oplev * Y * X1;
  const T* xfx_p = xfx + oplev * Y * X1;
  const T* cry_p = cry + oplev * Y1 * X;
  const T* yfx_p = yfx + oplev * Y1 * X;
  const T* area_p = area + (long long)s * Y * X;

  // --- stage the tile and its stencil halo (wrapped like a roll)
  for (int idx = threadIdx.x; idx < NS; idx += kThreads) {
    const int a = idx / SX;
    const int b = idx - a * SX;
    const int gj = wrap(j0 - R + a, Y);
    const int gi = wrap(i0 - R + b, X);
    const T vx = qx_p[gj * X + gi];
    s_qx[idx] = vx;
    T vy;
    if (qy_mode == 0) {
      vy = qy[qlev * Y * X + gj * X + gi];
    } else {
      const int pr = gj < h ? gj : (gj >= Y - h ? gj - (Y - h) + h : -1);
      const int pc = gi < h ? gi : (gi >= X - h ? gi - (X - h) + h : -1);
      vy = (pr >= 0 && pc >= 0) ? qy[qlev * 4 * h * h + pr * 2 * h + pc] : vx;
    }
    s_qy[idx] = vy;
    s_crx[idx] = crx_p[gj * X1 + gi];
    s_xfx[idx] = xfx_p[gj * X1 + gi];
    s_cry[idx] = cry_p[gj * X + gi];
    s_yfx[idx] = yfx_p[gj * X + gi];
    s_area[idx] = area_p[gj * X + gi];
  }
  __syncthreads();

  // --- inner 1-D fluxes: fx1 of qx (all rows, interface cols R..TX+R),
  //     fy1 of qy (interface rows R..TY+R, all cols)
  for (int idx = threadIdx.x; idx < SY * (TX + 1); idx += kThreads) {
    const int a = idx / (TX + 1);
    const int b = R + idx - a * (TX + 1);
    const T* r = s_qx + a * SX + b;
    s_fx1[a * SX + b] =
        flux_1d<T, HORD>(r[-3], r[-2], r[-1], r[0], r[1], r[2], s_crx[a * SX + b]);
  }
  for (int idx = threadIdx.x; idx < (TY + 1) * SX; idx += kThreads) {
    const int a = R + idx / SX;
    const int b = idx - (a - R) * SX;
    const T* c = s_qy + a * SX + b;
    s_fy1[a * SX + b] = flux_1d<T, HORD>(c[-3 * SX], c[-2 * SX], c[-SX], c[0],
                                         c[SX], c[2 * SX], s_cry[a * SX + b]);
  }
  __syncthreads();

  // --- inner updates, in place over the staged fields:
  //     q_i = (qy*area + (gy - gy[+1])) / (area + (yfx - yfx[+1])), gy = yfx*fy1
  //     q_j = (qx*area + (gx - gx[+1])) / (area + (xfx - xfx[+1])), gx = xfx*fx1
  for (int idx = threadIdx.x; idx < TY * (SX - 1); idx += kThreads) {
    const int a = R + idx / (SX - 1);
    const int b = idx - (a - R) * (SX - 1);
    const int m = a * SX + b;
    const T g0 = s_yfx[m] * s_fy1[m];
    const T g1 = s_yfx[m + SX] * s_fy1[m + SX];
    const T ra = s_area[m] + (s_yfx[m] - s_yfx[m + SX]);
    s_qy[m] = (s_qy[m] * s_area[m] + (g0 - g1)) / ra;
  }
  for (int idx = threadIdx.x; idx < (SY - 1) * TX; idx += kThreads) {
    const int a = idx / TX;
    const int b = R + idx - a * TX;
    const int m = a * SX + b;
    const T g0 = s_xfx[m] * s_fx1[m];
    const T g1 = s_xfx[m + 1] * s_fx1[m + 1];
    const T ra = s_area[m] + (s_xfx[m] - s_xfx[m + 1]);
    s_qx[m] = (s_qx[m] * s_area[m] + (g0 - g1)) / ra;
  }
  __syncthreads();

  // --- outer sweeps and the weighted results
  T* fx_p = fx + qlev * Y * X1;
  T* fy_p = fy + qlev * Y1 * X;
  const T* mfx_p = mfx ? mfx + oplev * Y * X1 : nullptr;
  const T* mfy_p = mfy ? mfy + oplev * Y1 * X : nullptr;
  for (int idx = threadIdx.x; idx < TY * TX; idx += kThreads) {
    const int a = idx / TX;
    const int b = idx - a * TX;
    const int j = j0 + a;
    const int i = i0 + b;
    if (j >= Y || i >= X) continue;
    const int m = (a + R) * SX + (b + R);
    const T* r = s_qy + m;  // q_i along the row
    const T fxo = flux_1d<T, HORD>(r[-3], r[-2], r[-1], r[0], r[1], r[2], s_crx[m]);
    const T wx = mfx_p ? mfx_p[j * X1 + i] : s_xfx[m];
    fx_p[j * X1 + i] = (T(0.5) * (fxo + s_fx1[m])) * wx;
    const T* c = s_qx + m;  // q_j along the column
    const T fyo = flux_1d<T, HORD>(c[-3 * SX], c[-2 * SX], c[-SX], c[0], c[SX],
                                   c[2 * SX], s_cry[m]);
    const T wy = mfy_p ? mfy_p[j * X + i] : s_yfx[m];
    fy_p[j * X + i] = (T(0.5) * (fyo + s_fy1[m])) * wy;
    if (i == X - 1) fx_p[j * X1 + X] = T(0);
    if (j == Y - 1) fy_p[Y * X + i] = T(0);
  }
}

template <typename T, int HORD>
int launch_hord(const void* qx, const void* qy, int qy_mode, int h,
                const void* crx, const void* cry, const void* xfx,
                const void* yfx, const void* area, const void* mfx,
                const void* mfy, void* fx, void* fy, int S, int NQ, int K,
                int Y, int X, void* stream) {
  const int tiles = ((Y + TY - 1) / TY) * ((X + TX - 1) / TX);
  const size_t smem = sizeof(T) * kArrays * NS;
  auto kern = fvtp2d_kernel<T, HORD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(tiles * NQ, K, S);
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)qx, (const T*)qy, qy_mode, h, (const T*)crx, (const T*)cry,
      (const T*)xfx, (const T*)yfx, (const T*)area, (const T*)mfx,
      (const T*)mfy, (T*)fx, (T*)fy, NQ, K, Y, X);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* qx, const void* qy, int qy_mode, int h, const void* crx,
           const void* cry, const void* xfx, const void* yfx, const void* area,
           const void* mfx, const void* mfy, void* fx, void* fy, int S, int NQ,
           int K, int Y, int X, int hord, void* stream) {
#define PACE_FVTP2D_ARGS \
  qx, qy, qy_mode, h, crx, cry, xfx, yfx, area, mfx, mfy, fx, fy, S, NQ, K, Y, X, stream
  switch (hord) {
    case 1: return launch_hord<T, 1>(PACE_FVTP2D_ARGS);
    case 5:
    case 6: return launch_hord<T, 6>(PACE_FVTP2D_ARGS);
    case 7: return launch_hord<T, 7>(PACE_FVTP2D_ARGS);
    case 8: return launch_hord<T, 8>(PACE_FVTP2D_ARGS);
    default: return -1;
  }
#undef PACE_FVTP2D_ARGS
}

// ---------------------------------------------------------------------------
// Several fields that share crx, cry, xfx, yfx, area and the mass fluxes
// (d_sw's pt / vorticity / w), each with its own hord, its own weighting
// (mass fluxes or area fluxes) and its own y-fold form (full array or corner
// pack). One block per (tile, level, shard) stages the five shared operands
// once, forms the two updated areas
//   ra_y = area + (yfx - yfx[+1]),   ra_x = area + (xfx - xfx[+1])
// once, and then takes the fields one after the other through the stages of
// fvtp2d_kernel above, in the same operation order, so every field's fx, fy
// equal the single-field launch's bit for bit (zero outermost interface
// column / row included). The kernel is instantiated once per hord for calls
// whose fields all share it (d_sw's usual case), and once with HORD = 0,
// where a switch per field picks the flux_1d instantiation: hord is uniform
// over a block, so the switch costs no divergence, but that instantiation
// carries the registers of its most expensive branch (hord 8) whatever runs.
// Bound on an H100: bytes. With three fields at C192 npz=79 f32: 3 qx, 4
// shared operands, 2 mass fluxes in, 6 flux arrays out, about 15 fields
// (~1.1 GB, ~0.33 ms at 3.35 TB/s) against 3 x 76 operations per point at
// hord 6 (~0.02 ms at 67 TFLOP/s). Three single-field launches would move
// 27 fields.

constexpr int kMaxFields = 4;
constexpr int kArraysMulti = 11;  // the nine of fvtp2d_kernel, ra_x, ra_y

// Blocks per SM that the multi-field kernel is compiled for. The kernel is
// held back by its shared-memory passes and arithmetic, not by operand
// traffic, so it needs the single-field kernel's occupancy to keep up with
// single-field launches: six blocks of float (40 registers a thread, a few
// spilled), four for the switch instantiation, whose spills at six cost more
// than the occupancy gains, three of double (shared memory allows no more).
template <typename T, int HORD>
constexpr int multi_blocks() {
  return sizeof(T) == 8 ? 3 : (HORD == 0 ? 4 : 6);
}

template <typename T>
struct MultiFields {
  const T* qx[kMaxFields];
  const T* qy[kMaxFields];
  T* fx[kMaxFields];
  T* fy[kMaxFields];
  int qy_mode[kMaxFields];  // 0: full (S, K, Y, X) array, 1: corner pack
  int hord[kMaxFields];     // 1, 6, 7 or 8 (5 is passed as 6)
  int use_mf[kMaxFields];   // weights: 1 mass fluxes, 0 area fluxes
  int n;
};

// One field through the staged tile: q and its y fold into shared memory,
// inner fluxes, inner updates in place, outer sweeps and the weighted
// results. All threads of the block call it together; it ends on a barrier
// so the next field may overwrite the staged arrays.
template <typename T, int HORD>
__device__ void transport_field(
    T* sm, const T* __restrict__ qx_p, const T* __restrict__ qy_p, int qy_mode,
    int h, const T* __restrict__ wx_p, const T* __restrict__ wy_p,
    T* __restrict__ fx_p, T* __restrict__ fy_p, int j0, int i0, int Y, int X) {
  T* s_qx = sm;
  T* s_qy = sm + NS;
  T* s_crx = sm + 2 * NS;
  T* s_cry = sm + 3 * NS;
  T* s_xfx = sm + 4 * NS;
  T* s_yfx = sm + 5 * NS;
  T* s_area = sm + 6 * NS;
  T* s_fx1 = sm + 7 * NS;
  T* s_fy1 = sm + 8 * NS;
  T* s_rax = sm + 9 * NS;
  T* s_ray = sm + 10 * NS;
  const int X1 = X + 1;

  for (int idx = threadIdx.x; idx < NS; idx += kThreads) {
    const int a = idx / SX;
    const int b = idx - a * SX;
    const int gj = wrap(j0 - R + a, Y);
    const int gi = wrap(i0 - R + b, X);
    const T vx = qx_p[gj * X + gi];
    s_qx[idx] = vx;
    T vy;
    if (qy_mode == 0) {
      vy = qy_p[gj * X + gi];
    } else {
      const int pr = gj < h ? gj : (gj >= Y - h ? gj - (Y - h) + h : -1);
      const int pc = gi < h ? gi : (gi >= X - h ? gi - (X - h) + h : -1);
      vy = (pr >= 0 && pc >= 0) ? qy_p[pr * 2 * h + pc] : vx;
    }
    s_qy[idx] = vy;
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < SY * (TX + 1); idx += kThreads) {
    const int a = idx / (TX + 1);
    const int b = R + idx - a * (TX + 1);
    const T* r = s_qx + a * SX + b;
    s_fx1[a * SX + b] =
        flux_1d<T, HORD>(r[-3], r[-2], r[-1], r[0], r[1], r[2], s_crx[a * SX + b]);
  }
  for (int idx = threadIdx.x; idx < (TY + 1) * SX; idx += kThreads) {
    const int a = R + idx / SX;
    const int b = idx - (a - R) * SX;
    const T* c = s_qy + a * SX + b;
    s_fy1[a * SX + b] = flux_1d<T, HORD>(c[-3 * SX], c[-2 * SX], c[-SX], c[0],
                                         c[SX], c[2 * SX], s_cry[a * SX + b]);
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < TY * (SX - 1); idx += kThreads) {
    const int a = R + idx / (SX - 1);
    const int b = idx - (a - R) * (SX - 1);
    const int m = a * SX + b;
    const T g0 = s_yfx[m] * s_fy1[m];
    const T g1 = s_yfx[m + SX] * s_fy1[m + SX];
    s_qy[m] = (s_qy[m] * s_area[m] + (g0 - g1)) / s_ray[m];
  }
  for (int idx = threadIdx.x; idx < (SY - 1) * TX; idx += kThreads) {
    const int a = idx / TX;
    const int b = R + idx - a * TX;
    const int m = a * SX + b;
    const T g0 = s_xfx[m] * s_fx1[m];
    const T g1 = s_xfx[m + 1] * s_fx1[m + 1];
    s_qx[m] = (s_qx[m] * s_area[m] + (g0 - g1)) / s_rax[m];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < TY * TX; idx += kThreads) {
    const int a = idx / TX;
    const int b = idx - a * TX;
    const int j = j0 + a;
    const int i = i0 + b;
    if (j >= Y || i >= X) continue;
    const int m = (a + R) * SX + (b + R);
    const T* r = s_qy + m;  // q_i along the row
    const T fxo = flux_1d<T, HORD>(r[-3], r[-2], r[-1], r[0], r[1], r[2], s_crx[m]);
    const T wx = wx_p ? wx_p[j * X1 + i] : s_xfx[m];
    fx_p[j * X1 + i] = (T(0.5) * (fxo + s_fx1[m])) * wx;
    const T* c = s_qx + m;  // q_j along the column
    const T fyo = flux_1d<T, HORD>(c[-3 * SX], c[-2 * SX], c[-SX], c[0], c[SX],
                                   c[2 * SX], s_cry[m]);
    const T wy = wy_p ? wy_p[j * X + i] : s_yfx[m];
    fy_p[j * X + i] = (T(0.5) * (fyo + s_fy1[m])) * wy;
    if (i == X - 1) fx_p[j * X1 + X] = T(0);
    if (j == Y - 1) fy_p[Y * X + i] = T(0);
  }
  __syncthreads();
}

// Grid: x = tile, y = level, z = shard. HORD: the hord of every field, or 0
// for fields of different hords (F.hord is read then).
template <typename T, int HORD>
__global__ void __launch_bounds__(kThreads, multi_blocks<T, HORD>())
fvtp2d_multi_kernel(
    MultiFields<T> F, int h, const T* __restrict__ crx,
    const T* __restrict__ cry, const T* __restrict__ xfx,
    const T* __restrict__ yfx, const T* __restrict__ area,
    const T* __restrict__ mfx, const T* __restrict__ mfy, int K, int Y, int X) {
  extern __shared__ unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* s_crx = sm + 2 * NS;
  T* s_cry = sm + 3 * NS;
  T* s_xfx = sm + 4 * NS;
  T* s_yfx = sm + 5 * NS;
  T* s_area = sm + 6 * NS;
  T* s_rax = sm + 9 * NS;
  T* s_ray = sm + 10 * NS;

  const int tiles_x = (X + TX - 1) / TX;
  const int j0 = (blockIdx.x / tiles_x) * TY;
  const int i0 = (blockIdx.x - (blockIdx.x / tiles_x) * tiles_x) * TX;
  const int X1 = X + 1;
  const int Y1 = Y + 1;
  const long long lev = (long long)blockIdx.z * K + blockIdx.y;
  const T* crx_p = crx + lev * Y * X1;
  const T* xfx_p = xfx + lev * Y * X1;
  const T* cry_p = cry + lev * Y1 * X;
  const T* yfx_p = yfx + lev * Y1 * X;
  const T* area_p = area + (long long)blockIdx.z * Y * X;

  // --- the shared operands, once for all fields
  for (int idx = threadIdx.x; idx < NS; idx += kThreads) {
    const int a = idx / SX;
    const int b = idx - a * SX;
    const int gj = wrap(j0 - R + a, Y);
    const int gi = wrap(i0 - R + b, X);
    s_crx[idx] = crx_p[gj * X1 + gi];
    s_xfx[idx] = xfx_p[gj * X1 + gi];
    s_cry[idx] = cry_p[gj * X + gi];
    s_yfx[idx] = yfx_p[gj * X + gi];
    s_area[idx] = area_p[gj * X + gi];
  }
  __syncthreads();
  // --- the updated areas of the two inner sweeps, where those read them
  for (int idx = threadIdx.x; idx < TY * (SX - 1); idx += kThreads) {
    const int a = R + idx / (SX - 1);
    const int m = a * SX + idx - (a - R) * (SX - 1);
    s_ray[m] = s_area[m] + (s_yfx[m] - s_yfx[m + SX]);
  }
  for (int idx = threadIdx.x; idx < (SY - 1) * TX; idx += kThreads) {
    const int a = idx / TX;
    const int m = a * SX + R + idx - a * TX;
    s_rax[m] = s_area[m] + (s_xfx[m] - s_xfx[m + 1]);
  }
  // (read after the barriers inside transport_field)

  for (int f = 0; f < F.n; ++f) {
    const T* qx_p = F.qx[f] + lev * Y * X;
    const T* qy_p = F.qy[f] + (F.qy_mode[f] ? lev * 4 * h * h : lev * Y * X);
    const T* wx_p = F.use_mf[f] ? mfx + lev * Y * X1 : nullptr;
    const T* wy_p = F.use_mf[f] ? mfy + lev * Y1 * X : nullptr;
    T* fx_p = F.fx[f] + lev * Y * X1;
    T* fy_p = F.fy[f] + lev * Y1 * X;
#define PACE_FIELD_ARGS \
  sm, qx_p, qy_p, F.qy_mode[f], h, wx_p, wy_p, fx_p, fy_p, j0, i0, Y, X
    if constexpr (HORD != 0) {
      transport_field<T, HORD>(PACE_FIELD_ARGS);
    } else {
      switch (F.hord[f]) {
        case 1: transport_field<T, 1>(PACE_FIELD_ARGS); break;
        case 6: transport_field<T, 6>(PACE_FIELD_ARGS); break;
        case 7: transport_field<T, 7>(PACE_FIELD_ARGS); break;
        default: transport_field<T, 8>(PACE_FIELD_ARGS); break;
      }
    }
#undef PACE_FIELD_ARGS
  }
}

template <typename T, int HORD>
int launch_multi_hord(const MultiFields<T>& F, int h, const void* crx,
                      const void* cry, const void* xfx, const void* yfx,
                      const void* area, const void* mfx, const void* mfy, int S,
                      int K, int Y, int X, void* stream) {
  const int tiles = ((Y + TY - 1) / TY) * ((X + TX - 1) / TX);
  const size_t smem = sizeof(T) * kArraysMulti * NS;
  auto kern = fvtp2d_multi_kernel<T, HORD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(tiles, K, S);
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      F, h, (const T*)crx, (const T*)cry, (const T*)xfx, (const T*)yfx,
      (const T*)area, (const T*)mfx, (const T*)mfy, K, Y, X);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_multi(const void* const* ptrs, const int* modes, int n, int h,
                 const void* crx, const void* cry, const void* xfx,
                 const void* yfx, const void* area, const void* mfx,
                 const void* mfy, int S, int K, int Y, int X, void* stream) {
  if (n < 1 || n > kMaxFields) return -2;
  MultiFields<T> F;
  F.n = n;
  for (int f = 0; f < kMaxFields; ++f) {
    const int g = f < n ? f : 0;  // unused slots repeat field 0, never read
    F.qx[f] = (const T*)ptrs[4 * g];
    F.qy[f] = (const T*)ptrs[4 * g + 1];
    F.fx[f] = (T*)ptrs[4 * g + 2];
    F.fy[f] = (T*)ptrs[4 * g + 3];
    F.qy_mode[f] = modes[3 * g];
    const int hord = modes[3 * g + 1];
    if (hord != 1 && (hord < 5 || hord > 8)) return -1;
    F.hord[f] = hord == 5 ? 6 : hord;
    F.use_mf[f] = modes[3 * g + 2];
    if (F.use_mf[f] && (mfx == nullptr || mfy == nullptr)) return -3;
  }
  int hord = F.hord[0];
  for (int f = 1; f < n; ++f)
    if (F.hord[f] != hord) hord = 0;
#define PACE_MULTI_ARGS F, h, crx, cry, xfx, yfx, area, mfx, mfy, S, K, Y, X, stream
  switch (hord) {
    case 1: return launch_multi_hord<T, 1>(PACE_MULTI_ARGS);
    case 6: return launch_multi_hord<T, 6>(PACE_MULTI_ARGS);
    case 7: return launch_multi_hord<T, 7>(PACE_MULTI_ARGS);
    case 8: return launch_multi_hord<T, 8>(PACE_MULTI_ARGS);
    default: return launch_multi_hord<T, 0>(PACE_MULTI_ARGS);
  }
#undef PACE_MULTI_ARGS
}

}  // namespace

extern "C" int pace_fvtp2d_f32(const void* qx, const void* qy, int qy_mode,
                               int h, const void* crx, const void* cry,
                               const void* xfx, const void* yfx,
                               const void* area, const void* mfx,
                               const void* mfy, void* fx, void* fy, int S,
                               int NQ, int K, int Y, int X, int hord,
                               void* stream) {
  return launch<float>(qx, qy, qy_mode, h, crx, cry, xfx, yfx, area, mfx, mfy,
                       fx, fy, S, NQ, K, Y, X, hord, stream);
}

extern "C" int pace_fvtp2d_f64(const void* qx, const void* qy, int qy_mode,
                               int h, const void* crx, const void* cry,
                               const void* xfx, const void* yfx,
                               const void* area, const void* mfx,
                               const void* mfy, void* fx, void* fy, int S,
                               int NQ, int K, int Y, int X, int hord,
                               void* stream) {
  return launch<double>(qx, qy, qy_mode, h, crx, cry, xfx, yfx, area, mfx, mfy,
                        fx, fy, S, NQ, K, Y, X, hord, stream);
}

// ptrs: host array of 4 n device pointers (qx, qy, fx, fy per field); modes:
// host array of 3 n ints (qy_mode, hord, use_mf per field); n <= 4 fields of
// shape (S, K, Y, X), corner packs (S, K, 2h, 2h).
extern "C" int pace_fvtp2d_multi_f32(const void* const* ptrs, const int* modes,
                                     int n, int h, const void* crx,
                                     const void* cry, const void* xfx,
                                     const void* yfx, const void* area,
                                     const void* mfx, const void* mfy, int S,
                                     int K, int Y, int X, void* stream) {
  return launch_multi<float>(ptrs, modes, n, h, crx, cry, xfx, yfx, area, mfx,
                             mfy, S, K, Y, X, stream);
}

extern "C" int pace_fvtp2d_multi_f64(const void* const* ptrs, const int* modes,
                                     int n, int h, const void* crx,
                                     const void* cry, const void* xfx,
                                     const void* yfx, const void* area,
                                     const void* mfx, const void* mfy, int S,
                                     int K, int Y, int X, void* stream) {
  return launch_multi<double>(ptrs, modes, n, h, crx, cry, xfx, yfx, area, mfx,
                              mfy, S, K, Y, X, stream);
}
