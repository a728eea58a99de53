// Lin & Rood (1996) 2-D PPM flux-form transport, fused in one kernel.
//
// Replaces pace_tpu/ops/fvtp2d_pallas.py `_kernel` (pallas_call at :212,
// entry fvtp2d_pallas :229): fvtp2d_single_kernel, last, with NQ = 1
// (mass-flux weights on or off); with NQ > 1 it runs a stacked block of NQ
// tracers, each tracer's fluxes those of a single-field launch.
// fvtp2d_multi_kernel replaces `_kernel_multi` (pallas_call at :390, entry
// fvtp2d_multi_pallas :578): up to four separate fields, each with its own
// hord, weighting and y-fold form, in one launch. fvtp2d_tracer_kernel
// replaces `_kernel_tracer` (pallas_call at :501, entry fvtp2d_tracer_pallas
// :519): a stacked block of tracers that share the Courant numbers, area
// fluxes, cell areas and mass fluxes, walked by each block.
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
// 3.35 TB/s. Every kernel of this file stages its tile and the stencil halo
// in shared memory by cp.async and keeps every intermediate (the inner
// fluxes and the inner updates) there: device memory sees one read of each
// operand tile (plus the halo overlap) and one write of fx and fy.

#include <cuda_runtime.h>

namespace {

constexpr int R = 3;  // one PPM sweep: interface i reads cells i-3 .. i+2
// the multi-field kernel's tile: TY x TX outputs, a window of SY x SX cells
constexpr int TY = 16;
constexpr int TX = 32;
constexpr int SY = TY + 2 * R;
constexpr int SX = TX + 2 * R;
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

// ---------------------------------------------------------------------------
// The interface values of ppm._flux_1d with each per-cell term formed once,
// for a thread that walks a line: al once per interface, (bl, br, b0) once
// per cell, and each interface's value from its two cells' terms. Every term
// is formed by the plain version's own expression, so the values are its
// bits.

// al of the interface between cells qm1 and q0 (hord 5, 6, 7)
template <typename T>
__device__ __forceinline__ T ppm_al(T qm2, T qm1, T q0, T qp1) {
  return T(7.0 / 12.0) * (qm1 + q0) - T(1.0 / 12.0) * (qm2 + qp1);
}

// al of the same interface at hord 8, from the two cells' mono slopes
template <typename T>
__device__ __forceinline__ T ppm_al8(T qm1, T q0, T dm_m1, T dm_0) {
  return T(0.5) * (qm1 + q0) + T(1.0 / 3.0) * (dm_m1 - dm_0);
}

template <typename T>
struct PpmCell {
  T bl, br, b0;
};

// a cell's interface perturbations from its mean and its two al (dm: its
// mono slope, read at hord 8 only)
template <typename T, int HORD>
__device__ __forceinline__ PpmCell<T> ppm_cell(T q, T al_l, T al_r, T dm) {
  T bl, br;
  if constexpr (HORD == 8) {
    mono_b(q, dm, al_l, al_r, bl, br);
  } else {
    bl = al_l - q;
    br = al_r - q;
    if constexpr (HORD == 7) positive_limit(q, bl, br);
  }
  return {bl, br, bl + br};
}

// the upstream profile mean at the interface between cells m1 and 0
template <typename T>
__device__ __forceinline__ T ppm_face(T qm1, const PpmCell<T>& m1, T q0,
                                      const PpmCell<T>& c0, T c) {
  const T f_pos = qm1 + (T(1.0) - c) * (m1.br - c * m1.b0);
  const T f_neg = q0 + (T(1.0) + c) * (c0.bl + c * c0.b0);
  return c > T(0) ? f_pos : f_neg;
}

// n <= N consecutive interface values along a line into out[0..n): interface
// t lies between cells q[(t-1) qs] and q[t qs], its courant number is
// cr[t cs]. Cells q[-3 qs] .. q[(n+1) qs] are read once each; the stencil
// window, the next al and the upwind cell's terms stay in registers.
template <typename T, int HORD, int N>
__device__ __forceinline__ void ppm_sweep(const T* q, int qs, const T* cr, int cs,
                                          int n, T (&out)[N]) {
  if constexpr (HORD == 1) {
    T qm1 = q[-qs];
#pragma unroll
    for (int t = 0; t < N; ++t) {
      if (t < n) {
        const T q0 = q[t * qs];
        out[t] = cr[t * cs] > T(0) ? qm1 : q0;
        qm1 = q0;
      }
    }
  } else {
    T qm1 = q[-qs], q0 = q[0], qp1 = q[qs];
    T al_0, dm_0 = T(0);
    PpmCell<T> cm1;
    {
      const T qm3 = q[-3 * qs], qm2 = q[-2 * qs];
      if constexpr (HORD == 8) {
        const T dm_m2 = dm_mono(qm3, qm2, qm1);
        const T dm_m1 = dm_mono(qm2, qm1, q0);
        dm_0 = dm_mono(qm1, q0, qp1);
        const T al_m1 = ppm_al8(qm2, qm1, dm_m2, dm_m1);
        al_0 = ppm_al8(qm1, q0, dm_m1, dm_0);
        cm1 = ppm_cell<T, 8>(qm1, al_m1, al_0, dm_m1);
      } else {
        const T al_m1 = ppm_al(qm3, qm2, qm1, q0);
        al_0 = ppm_al(qm2, qm1, q0, qp1);
        cm1 = ppm_cell<T, HORD>(qm1, al_m1, al_0, T(0));
      }
    }
#pragma unroll
    for (int t = 0; t < N; ++t) {
      if (t < n) {
        const T qp2 = q[(t + 2) * qs];
        T al_p1, dm_p1 = T(0);
        if constexpr (HORD == 8) {
          dm_p1 = dm_mono(q0, qp1, qp2);
          al_p1 = ppm_al8(q0, qp1, dm_0, dm_p1);
        } else {
          al_p1 = ppm_al(qm1, q0, qp1, qp2);
        }
        const PpmCell<T> c0 = ppm_cell<T, HORD>(q0, al_0, al_p1, dm_0);
        out[t] = ppm_face(qm1, cm1, q0, c0, cr[t * cs]);
        qm1 = q0;
        q0 = qp1;
        qp1 = qp2;
        al_0 = al_p1;
        dm_0 = dm_p1;
        cm1 = c0;
      }
    }
  }
}

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// ---------------------------------------------------------------------------
// Several fields that share crx, cry, xfx, yfx, area and the mass fluxes
// (d_sw's pt / vorticity / w), each with its own hord, its own weighting
// (mass fluxes or area fluxes) and its own y-fold form (full array or corner
// pack), in one launch. Every field's fx, fy equal the single-field launch's
// bit for bit (zero outermost interface column / row included): every
// kernel of this file runs the same stages (transport_field) on its tile.
// Bound on an H100: bytes. With three fields at C192 npz=79 f32: 3 qx, 4
// shared operands, 2 mass fluxes in, 6 flux arrays out, about 15 fields
// (~1.1 GB, ~0.33 ms at 3.35 TB/s) against 3 x 76 operations per point at
// hord 6 (~0.02 ms at 67 TFLOP/s). Three single-field launches would move
// 27 fields.
// Design: one block per (16 x 32 tile, level, shard), 256 threads.
// - The window's plane rows and columns (wrapped like a roll only at the
//   plane's edges) are formed once per block; staging then costs a
//   table read, an address and a cp.async per value, no modulo.
// - The shared operands arrive once by cp.async. The updated areas of the
//   inner updates, ra_y = area + (yfx - yfx[+1]) and ra_x = area + (xfx -
//   xfx[+1]), are formed where each update reads them: two operations
//   cost less than a pass, a barrier and two arrays.
// - Fields run in a pipeline: field f + 1's qx / qy are in flight by
//   cp.async into the second buffer pair while field f is computed.
// - Each 1-D sweep is a thread walking a short segment of a line with
//   ppm_sweep: al once per interface of the segment, the cell terms once
//   per cell. Per field: the inner sweeps (21 rows of 33 x-interfaces and
//   37 columns of 17 y-interfaces, the ones the updates and results read,
//   in segments of kSegIn), the inner updates in place, the outer sweeps
//   (16 rows of 32 and 32 columns of 16 interfaces in segments of
//   kSegOut), averaged with the inner fluxes in place, and the weighted
//   results stored with a warp's lanes on consecutive interfaces; four
//   barriers. Segment lengths and blocks an SM were chosen by timing the
//   candidates on an H100 (tools/torch_kernel_variants.py, PERF.md): longer
//   segments save arithmetic but cost registers, and spills.
// - Rows of the staged arrays are LD = 41 values apart, so that the lanes
//   of a warp on different rows read different banks.
// - 11 arrays of 22 x 41 values: 40 KB of float, four blocks an SM (64
//   registers a thread).

constexpr int kMaxFields = 4;
// crx, cry, xfx, yfx, area, two buffers of (qx, qy), fx1, fy1
constexpr int kArraysMulti = 11;
// Row stride of the staged arrays: 41 = 9 mod 32, so that the lanes of a warp
// that walk different rows (inner x sweep) or segments of a few rows (outer
// x sweep) read different shared-memory banks.
constexpr int LD = 41;
constexpr int NSM = SY * LD;  // values per staged array

// The geometry of a tile that the routines below stage and sweep: TY x TX
// outputs, its window of SY x SX cells with the stencil halo, staged rows LD
// values apart (NSM values an array). Each routine takes it as a template
// argument and names its members as the file's constants of the same names.
template <int TY_, int TX_, int LD_>
struct Tile {
  static constexpr int TY = TY_, TX = TX_, SY = TY_ + 2 * R, SX = TX_ + 2 * R, LD = LD_,
                       NSM = SY * LD_;
  // staging: a thread keeps one column of the window and takes every
  // kStageRows-th row (6 rows of 38 columns at a time at 16 x 32)
  static constexpr int kStageRows = kThreads / SX;
  static_assert(LD_ >= SX, "a staged row holds the window's row");
};
// the multi-field kernel's: 16 x 32 outputs, rows 41 apart
using MultiTile = Tile<TY, TX, LD>;
constexpr int kSegIn = 3;   // interfaces a thread walks in an inner sweep
constexpr int kSegOut = 2;  // ... in an outer sweep
// The inner sweeps cover the rows (columns) that the updates and the
// results read: fx1 on rows 0 .. SY-2, fy1 on columns 0 .. SX-2.

// Blocks per SM that the multi-field kernel is compiled for (shared memory
// allows four of float, two of double).
template <typename T>
constexpr int multi_blocks() {
  return sizeof(T) == 8 ? 2 : 4;
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

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
               "n"(sizeof(T)));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The plane rows and columns of a tile's staged window, formed once per
// block: the tile's own rows and columns, and those of its stencil halo,
// wrapped like a roll only where they fall off the plane; and their places
// in the y-fold corner pack (-1 outside the pack's rows or columns).
template <class G>
struct Window {
  int gj[G::SY], gi[G::SX];
  int pr[G::SY], pc[G::SX];
};

template <class G>
__device__ __forceinline__ void form_window(Window<G>& w, int j0, int i0, int h, int Y, int X) {
  constexpr int SY = G::SY, SX = G::SX;
  const int t = threadIdx.x;
  if (t < SY) {
    int gj = j0 - R + t;
    if (gj < 0 || gj >= Y) gj = wrap(gj, Y);
    w.gj[t] = gj;
    w.pr[t] = gj < h ? gj : (gj >= Y - h ? gj - (Y - h) + h : -1);
  } else if (t < SY + SX) {
    int gi = i0 - R + (t - SY);
    if (gi < 0 || gi >= X) gi = wrap(gi, X);
    w.gi[t - SY] = gi;
    w.pc[t - SY] = gi < h ? gi : (gi >= X - h ? gi - (X - h) + h : -1);
  }
}

// One field's qx and y fold into a buffer pair, by cp.async (no commit).
template <typename T, class G>
__device__ __forceinline__ void stage_field(
    T* s_qx, T* s_qy, const T* __restrict__ qx_p, const T* __restrict__ qy_p,
    int qy_mode, int h, const Window<G>& win, int X) {
  constexpr int SY = G::SY, SX = G::SX, LD = G::LD, kStageRows = G::kStageRows;
  const int t = threadIdx.x;
  if (t >= kStageRows * SX) return;
  const int b = t % SX;
  const int gi = win.gi[b], pc = win.pc[b];
  for (int a = t / SX; a < SY; a += kStageRows) {
    const int m = a * LD + b;
    const int gj = win.gj[a];
    const T* src = qx_p + gj * X + gi;
    cp_async(s_qx + m, src);
    if (qy_mode == 0) {
      src = qy_p + gj * X + gi;
    } else {  // the corner pack where both the row and the column lie in it
      const int pr = win.pr[a];
      if (pr >= 0 && pc >= 0) src = qy_p + pr * 2 * h + pc;
    }
    cp_async(s_qy + m, src);
  }
}

// The operands of one level into the window by cp.async (no commit): crx,
// cry, xfx, yfx and the cell areas, NSM values apart from s_ops. (The
// multi-field and tracer kernels stage their shared operands with the same
// loop written inline: calling this routine there cost row 3 about 1% on an
// H100, PERF.md.)
template <typename T, class G>
__device__ __forceinline__ void stage_operands(
    T* s_ops, const T* __restrict__ crx_p, const T* __restrict__ cry_p,
    const T* __restrict__ xfx_p, const T* __restrict__ yfx_p, const T* __restrict__ area_p,
    const Window<G>& win, int X) {
  constexpr int SY = G::SY, SX = G::SX, LD = G::LD, NSM = G::NSM, kStageRows = G::kStageRows;
  const int t = threadIdx.x;
  if (t >= kStageRows * SX) return;
  const int X1 = X + 1;
  const int b = t % SX;
  const int gi = win.gi[b];
  for (int a = t / SX; a < SY; a += kStageRows) {
    const int m = a * LD + b;
    const int gj = win.gj[a];
    cp_async(s_ops + m, crx_p + gj * X1 + gi);
    cp_async(s_ops + 2 * NSM + m, xfx_p + gj * X1 + gi);
    cp_async(s_ops + NSM + m, cry_p + gj * X + gi);
    cp_async(s_ops + 3 * NSM + m, yfx_p + gj * X + gi);
    cp_async(s_ops + 4 * NSM + m, area_p + gj * X + gi);
  }
}

// One field through the staged tile: the inner sweeps, the inner updates in
// place, the outer sweeps and the weighted results. All threads of the block
// call it together; it ends on a barrier so the buffers may be refilled.
// G: the tile. SI, SO: the interfaces a thread walks in an inner and an
// outer sweep. From sm, in arrays of NSM values: the staged crx, cry, xfx,
// yfx and area, and at array FLUX room for the inner fluxes fx1, fy1.
template <typename T, int HORD, class G = MultiTile, int SI = kSegIn, int SO = kSegOut,
          int FLUX = 9>
__device__ void transport_field(
    T* sm, T* s_qx, T* s_qy, const T* __restrict__ wx_p,
    const T* __restrict__ wy_p, T* __restrict__ fx_p, T* __restrict__ fy_p, int j0, int i0,
    int Y, int X) {
  constexpr int TY = G::TY, TX = G::TX, SY = G::SY, SX = G::SX, LD = G::LD, NSM = G::NSM;
  const T* s_crx = sm;
  const T* s_cry = sm + NSM;
  const T* s_xfx = sm + 2 * NSM;
  const T* s_yfx = sm + 3 * NSM;
  const T* s_area = sm + 4 * NSM;
  T* s_fx1 = sm + FLUX * NSM;
  T* s_fy1 = sm + (FLUX + 1) * NSM;
  const int X1 = X + 1;
  const int tid = threadIdx.x;
  static_assert(TX % SO == 0 && TY % SO == 0, "outer segments tile the tile");
  constexpr int kInX = (SY - 1) * ((TX + 1 + SI - 1) / SI);  // a row's inner x segments
  constexpr int kInY = (SX - 1) * ((TY + 1 + SI - 1) / SI);  // a column's inner y segments
  constexpr int kOutX = TY * (TX / SO);
  constexpr int kOutY = TX * (TY / SO);

  // inner sweeps: fx1 of qx along rows (interface cols R..TX+R; a warp's
  // lanes on consecutive rows), fy1 of qy along columns (interface rows
  // R..TY+R; lanes on consecutive columns)
  for (int it = tid; it < kInX + kInY; it += kThreads) {
    if (it < kInX) {
      const int a = it % (SY - 1);
      const int b = R + (it / (SY - 1)) * SI;
      const int n = min(SI, TX + R + 1 - b);
      const int m = a * LD + b;
      T f[SI];
      ppm_sweep<T, HORD>(s_qx + m, 1, s_crx + m, 1, n, f);
#pragma unroll
      for (int t = 0; t < SI; ++t)
        if (t < n) s_fx1[m + t] = f[t];
    } else {
      const int e = it - kInX;
      const int b = e % (SX - 1);
      const int a = R + (e / (SX - 1)) * SI;
      const int n = min(SI, TY + R + 1 - a);
      const int m = a * LD + b;
      T f[SI];
      ppm_sweep<T, HORD>(s_qy + m, LD, s_cry + m, LD, n, f);
#pragma unroll
      for (int t = 0; t < SI; ++t)
        if (t < n) s_fy1[m + t * LD] = f[t];
    }
  }
  __syncthreads();

  // inner updates, in place over the staged fields:
  //   q_i = (qy*area + (gy - gy[+1])) / (area + (yfx - yfx[+1])), gy = yfx*fy1
  //   q_j = (qx*area + (gx - gx[+1])) / (area + (xfx - xfx[+1])), gx = xfx*fx1
  for (int idx = tid; idx < TY * (SX - 1); idx += kThreads) {
    const int a = R + idx / (SX - 1);
    const int b = idx - (a - R) * (SX - 1);
    const int m = a * LD + b;
    const T g0 = s_yfx[m] * s_fy1[m];
    const T g1 = s_yfx[m + LD] * s_fy1[m + LD];
    const T ra = s_area[m] + (s_yfx[m] - s_yfx[m + LD]);
    s_qy[m] = (s_qy[m] * s_area[m] + (g0 - g1)) / ra;
  }
  for (int idx = tid; idx < (SY - 1) * TX; idx += kThreads) {
    const int a = idx / TX;
    const int b = R + idx - a * TX;
    const int m = a * LD + b;
    const T g0 = s_xfx[m] * s_fx1[m];
    const T g1 = s_xfx[m + 1] * s_fx1[m + 1];
    const T ra = s_area[m] + (s_xfx[m] - s_xfx[m + 1]);
    s_qx[m] = (s_qx[m] * s_area[m] + (g0 - g1)) / ra;
  }
  __syncthreads();

  // outer sweeps: fx of q_i along the tile's rows (a warp's lanes on the
  // segments of two rows), fy of q_j along its columns (lanes on
  // consecutive columns); each averaged with the inner flux in place
  for (int it = tid; it < kOutX + kOutY; it += kThreads) {
    if (it < kOutX) {
      const int a = it / (TX / SO);
      const int b = (it - a * (TX / SO)) * SO;
      const int m = (a + R) * LD + (b + R);
      T f[SO];
      ppm_sweep<T, HORD>(s_qy + m, 1, s_crx + m, 1, SO, f);
#pragma unroll
      for (int t = 0; t < SO; ++t) s_fx1[m + t] = T(0.5) * (f[t] + s_fx1[m + t]);
    } else {
      const int e = it - kOutX;
      const int a = (e / TX) * SO;
      const int b = e - (e / TX) * TX;
      const int m = (a + R) * LD + (b + R);
      T f[SO];
      ppm_sweep<T, HORD>(s_qx + m, LD, s_cry + m, LD, SO, f);
#pragma unroll
      for (int t = 0; t < SO; ++t)
        s_fy1[m + t * LD] = T(0.5) * (f[t] + s_fy1[m + t * LD]);
    }
  }
  __syncthreads();

  // the weighted results, a warp's lanes on consecutive interfaces of a row
  for (int idx = tid; idx < TY * TX; idx += kThreads) {
    const int a = idx / TX;
    const int b = idx - a * TX;
    const int j = j0 + a;
    const int i = i0 + b;
    if (j >= Y || i >= X) continue;
    const int m = (a + R) * LD + (b + R);
    const T wx = wx_p ? wx_p[j * X1 + i] : s_xfx[m];
    fx_p[j * X1 + i] = s_fx1[m] * wx;
    const T wy = wy_p ? wy_p[j * X + i] : s_yfx[m];
    fy_p[j * X + i] = s_fy1[m] * wy;
    if (i == X - 1) fx_p[j * X1 + X] = T(0);
    if (j == Y - 1) fy_p[Y * X + i] = T(0);
  }
  __syncthreads();
}

// Grid: x = tile, y = level, z = shard. HORD: the hord of every field, or 0
// for fields of different hords (F.hord is read then).
template <typename T, int HORD>
__global__ void __launch_bounds__(kThreads, multi_blocks<T>())
fvtp2d_multi_kernel(
    MultiFields<T> F, int h, const T* __restrict__ crx,
    const T* __restrict__ cry, const T* __restrict__ xfx,
    const T* __restrict__ yfx, const T* __restrict__ area,
    const T* __restrict__ mfx, const T* __restrict__ mfy, int K, int Y, int X) {
  using G = MultiTile;
  constexpr int kStageRows = G::kStageRows;
  extern __shared__ unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* s_crx = sm;
  T* s_cry = sm + NSM;
  T* s_xfx = sm + 2 * NSM;
  T* s_yfx = sm + 3 * NSM;
  T* s_area = sm + 4 * NSM;
  T* s_buf = sm + 5 * NSM;  // buffer pair p: qx at s_buf + 2p NSM, qy after it

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
  __shared__ Window<G> win;
  form_window(win, j0, i0, h, Y, X);
  __syncthreads();

  // the shared operands, once for all fields, then the first two fields
  if (threadIdx.x < kStageRows * SX) {
    const int b = threadIdx.x % SX;
    const int gi = win.gi[b];
    for (int a = threadIdx.x / SX; a < SY; a += kStageRows) {
      const int m = a * LD + b;
      const int gj = win.gj[a];
      cp_async(s_crx + m, crx_p + gj * X1 + gi);
      cp_async(s_xfx + m, xfx_p + gj * X1 + gi);
      cp_async(s_cry + m, cry_p + gj * X + gi);
      cp_async(s_yfx + m, yfx_p + gj * X + gi);
      cp_async(s_area + m, area_p + gj * X + gi);
    }
  }
  auto stage = [&](int f) {
    T* b = s_buf + 2 * (f & 1) * NSM;
    const T* qy_p = F.qy[f] + (F.qy_mode[f] ? lev * 4 * h * h : lev * Y * X);
    stage_field(b, b + NSM, F.qx[f] + lev * Y * X, qy_p, F.qy_mode[f], h, win, X);
    cp_async_commit();
  };
  stage(0);
  if (F.n > 1) stage(1);

  for (int f = 0; f < F.n; ++f) {
    if (f + 1 < F.n)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    T* b = s_buf + 2 * (f & 1) * NSM;
    const T* wx_p = F.use_mf[f] ? mfx + lev * Y * X1 : nullptr;
    const T* wy_p = F.use_mf[f] ? mfy + lev * Y1 * X : nullptr;
    T* fx_p = F.fx[f] + lev * Y * X1;
    T* fy_p = F.fy[f] + lev * Y1 * X;
#define PACE_FIELD_ARGS \
  sm, b, b + NSM, wx_p, wy_p, fx_p, fy_p, j0, i0, Y, X
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
    if (f + 2 < F.n) stage(f + 2);
  }
}

template <typename T, int HORD>
int launch_multi_hord(const MultiFields<T>& F, int h, const void* crx,
                      const void* cry, const void* xfx, const void* yfx,
                      const void* area, const void* mfx, const void* mfy, int S,
                      int K, int Y, int X, void* stream) {
  const int tiles = ((Y + TY - 1) / TY) * ((X + TX - 1) / TX);
  const size_t smem = sizeof(T) * kArraysMulti * NSM;
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

// ---------------------------------------------------------------------------
// A stacked tracer block (S, NQ, K, Y, X) that shares crx, cry, xfx, yfx,
// area and the mass fluxes, every tracer with one hord and one y-fold form.
// Each tracer's fx, fy equal the single-field launch's bit for bit (and
// fvtp2d_single_kernel's with NQ tracers, whose blocks hold one tracer each).
// Bound on an H100: bytes. At C192 npz=79 with nine tracers and the corner
// pack: 9 qx, 9 fx, 9 fy, the four shared operands, the two mass fluxes and
// the packs, about 33 fields (~2.5 GB, ~0.74 ms at 3.35 TB/s), against 9 x
// 156 operations per point at hord 8 (~0.17 ms at 67 TFLOP/s).
// Design: the multi-field kernel's, with the tracers in place of its fields.
// One block per (20 x 40 tile, level, shard) walks all NQ tracers:
// - the window's rows and columns are formed once (form_window), the shared
//   operands arrive once by cp.async for all tracers;
// - tracers run in a pipeline: tracer t + 1's qx and corner pack are in
//   flight by cp.async into the second buffer pair while tracer t is
//   computed (stage_field);
// - each tracer goes through transport_field: the 1-D sweeps by ppm_sweep
//   in segments of kSegInTracer / kSegOutTracer interfaces (the outer
//   sweeps' 400 segments fill the block's threads in two rounds), results
//   stored from shared memory with a warp's lanes on consecutive
//   interfaces;
// - the tile (TracerTile) is larger than the multi-field kernel's: 20 x 40
//   cuts the 198 x 198 plane into 10 x 5 tiles with 1% idle (16 x 32: 13 x 7
//   with 16% idle) and the stencil halo is a smaller share of it. Rows are
//   LD = 47 values apart (odd, so the lanes of a warp on different rows read
//   different banks). The multi-field kernel's 11 arrays, of 26 x 47 values:
//   54 KB of float, four blocks an SM at 64 registers;
// - the work every tracer repeats on the shared operands alone stays where
//   each tracer's passes read it: the updated areas ra_y = area + (yfx -
//   yfx[+1]) and ra_x = area + (xfx - xfx[+1]) formed once a block into two
//   arrays measured slower on an H100 than the two additions in each update
//   (PERF.md), and the Courant factors (1 - c), (1 + c) kept in shared
//   memory would replace one addition by one load each.
// Tile, segment lengths and blocks an SM were chosen by timing the
// candidates on an H100 (tools/torch_kernel_variants.py, PERF.md).

constexpr int kSegInTracer = 3;   // interfaces a thread walks in an inner sweep
constexpr int kSegOutTracer = 4;  // ... in an outer sweep
// the tracer kernel's tile: 20 x 40 outputs (10 x 5 tiles on the 198 x 198
// plane, 99% of them used), rows 47 apart (odd: the lanes of a warp on
// different rows read different banks)
using TracerTile = Tile<20, 40, 47>;

// Blocks per SM that the tracer kernel is compiled for (shared memory allows
// four of float, two of double).
template <typename T>
constexpr int tracer_blocks() {
  return sizeof(T) == 8 ? 2 : 4;
}

// Grid: x = tile, y = level, z = shard. qy_mode as fvtp2d_single_kernel's.
template <typename T, int HORD>
__global__ void __launch_bounds__(kThreads, tracer_blocks<T>())
fvtp2d_tracer_kernel(
    const T* __restrict__ qx, const T* __restrict__ qy, int qy_mode, int h,
    const T* __restrict__ crx, const T* __restrict__ cry,
    const T* __restrict__ xfx, const T* __restrict__ yfx,
    const T* __restrict__ area, const T* __restrict__ mfx,
    const T* __restrict__ mfy, T* __restrict__ fx, T* __restrict__ fy,
    int NQ, int K, int Y, int X) {
  using G = TracerTile;
  constexpr int TY = G::TY, TX = G::TX, SY = G::SY, SX = G::SX, LD = G::LD, NSM = G::NSM;
  constexpr int kStageRows = G::kStageRows;
  extern __shared__ unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* s_crx = sm;
  T* s_cry = sm + NSM;
  T* s_xfx = sm + 2 * NSM;
  T* s_yfx = sm + 3 * NSM;
  T* s_area = sm + 4 * NSM;
  T* s_buf = sm + 5 * NSM;  // buffer pair p: qx at s_buf + 2p NSM, qy after it

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
  const T* wx_p = mfx ? mfx + lev * Y * X1 : nullptr;
  const T* wy_p = mfy ? mfy + lev * Y1 * X : nullptr;
  __shared__ Window<G> win;
  form_window(win, j0, i0, h, Y, X);
  __syncthreads();

  // the shared operands, once for all tracers, then the first two tracers
  if (threadIdx.x < kStageRows * SX) {
    const int b = threadIdx.x % SX;
    const int gi = win.gi[b];
    for (int a = threadIdx.x / SX; a < SY; a += kStageRows) {
      const int m = a * LD + b;
      const int gj = win.gj[a];
      cp_async(s_crx + m, crx_p + gj * X1 + gi);
      cp_async(s_xfx + m, xfx_p + gj * X1 + gi);
      cp_async(s_cry + m, cry_p + gj * X + gi);
      cp_async(s_yfx + m, yfx_p + gj * X + gi);
      cp_async(s_area + m, area_p + gj * X + gi);
    }
  }
  // tracer t's planes: level (s, t, k) of the block
  auto plane = [&](int t) { return ((long long)blockIdx.z * NQ + t) * K + blockIdx.y; };
  auto stage = [&](int t) {
    T* b = s_buf + 2 * (t & 1) * NSM;
    const long long q = plane(t);
    stage_field(b, b + NSM, qx + q * Y * X, qy + (qy_mode ? q * 4 * h * h : q * Y * X),
                qy_mode, h, win, X);
    cp_async_commit();
  };
  stage(0);
  if (NQ > 1) stage(1);

  for (int t = 0; t < NQ; ++t) {
    if (t + 1 < NQ)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    T* b = s_buf + 2 * (t & 1) * NSM;
    const long long q = plane(t);
    transport_field<T, HORD, G, kSegInTracer, kSegOutTracer>(
        sm, b, b + NSM, wx_p, wy_p, fx + q * Y * X1,
                                           fy + q * Y1 * X, j0, i0, Y, X);
    if (t + 2 < NQ) stage(t + 2);
  }
}

template <typename T, int HORD>
int launch_tracer_hord(const void* qx, const void* qy, int qy_mode, int h,
                       const void* crx, const void* cry, const void* xfx,
                       const void* yfx, const void* area, const void* mfx,
                       const void* mfy, void* fx, void* fy, int S, int NQ, int K,
                       int Y, int X, void* stream) {
  using G = TracerTile;
  const int tiles = ((Y + G::TY - 1) / G::TY) * ((X + G::TX - 1) / G::TX);
  const size_t smem = sizeof(T) * kArraysMulti * G::NSM;
  auto kern = fvtp2d_tracer_kernel<T, HORD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(tiles, K, S);
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)qx, (const T*)qy, qy_mode, h, (const T*)crx, (const T*)cry,
      (const T*)xfx, (const T*)yfx, (const T*)area, (const T*)mfx,
      (const T*)mfy, (T*)fx, (T*)fy, NQ, K, Y, X);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tracer(const void* qx, const void* qy, int qy_mode, int h, const void* crx,
                  const void* cry, const void* xfx, const void* yfx, const void* area,
                  const void* mfx, const void* mfy, void* fx, void* fy, int S, int NQ,
                  int K, int Y, int X, int hord, void* stream) {
  if (NQ < 1) return -2;
#define PACE_TRACER_ARGS \
  qx, qy, qy_mode, h, crx, cry, xfx, yfx, area, mfx, mfy, fx, fy, S, NQ, K, Y, X, stream
  switch (hord) {
    case 1: return launch_tracer_hord<T, 1>(PACE_TRACER_ARGS);
    case 5:
    case 6: return launch_tracer_hord<T, 6>(PACE_TRACER_ARGS);
    case 7: return launch_tracer_hord<T, 7>(PACE_TRACER_ARGS);
    case 8: return launch_tracer_hord<T, 8>(PACE_TRACER_ARGS);
    default: return -1;
  }
#undef PACE_TRACER_ARGS
}

// ---------------------------------------------------------------------------
// One field (S, K, Y, X) with its own Courant numbers and area fluxes at
// every level (d_sw's delp mass fluxes, updatedz_d's interface heights); with
// NQ > 1 a stacked block (S, NQ, K, Y, X) of fields that share them, each
// tracer's fluxes those of a single-field launch.
// Bound on an H100: bytes. At C192 npz=79 f32 with the corner pack and
// area-flux weights: qx, crx, cry, xfx, yfx, area and the pack in, fx and fy
// out, about 7 fields (~0.52 GB, ~0.16 ms at 3.35 TB/s), against 76
// operations per point at hord 6 (~0.02 ms at 67 TFLOP/s).
// Design: the stages of the multi-field and tracer kernels (form_window,
// the operands' staging, stage_field, transport_field) on a tile of its
// own, one block per (20 x 40 tile, level, shard[, tracer]):
// - the window's rows and columns are formed once a block; the operands and
//   the field arrive by cp.async with no modulo per staged value;
// - the 1-D sweeps by ppm_sweep in segments of kSegInSingle / kSegOutSingle
//   interfaces, the results stored from shared memory with a warp's lanes
//   on consecutive interfaces;
// - the tile (SingleTile) cuts the 198 x 198 plane into 10 x 5 tiles of 20 x
//   40 with 1% idle (16 x 32: 13 x 7 with 16% idle); rows LD = 47 values
//   apart (odd: the lanes of a warp on different rows read different banks);
// - what holds it is its passes, not its loads (PERF.md): the passes need
//   warps, so a block stages one level and no more, 9 arrays of 26 x 47
//   values, 44 KB of float, four blocks an SM at 64 registers. A block that
//   walks a run of levels with the next level in flight by cp.async (two
//   level buffers, three blocks an SM) and the tracer kernel at NQ = 1 were
//   built and measured slower on an H100 (PERF.md).
// Tile, segment lengths and blocks an SM were chosen by timing the
// candidates on an H100 (tools/torch_kernel_variants.py, PERF.md).

constexpr int kSegInSingle = 3;   // interfaces a thread walks in an inner sweep
constexpr int kSegOutSingle = 4;  // ... in an outer sweep
using SingleTile = Tile<20, 40, 47>;
// crx, cry, xfx, yfx, area, qx, qy, fx1, fy1
constexpr int kArraysSingle = 9;

// Blocks per SM that the single-field kernel is compiled for (shared memory
// allows five of float, two of double).
template <typename T>
constexpr int single_blocks() {
  return sizeof(T) == 8 ? 2 : 4;
}

// Grid: x = tile, y = level, z = shard * NQ + tracer.
// qy_mode 0: qy is a full (S, NQ, K, Y, X) array; 1: qy is the y-fold
// corner pack (S, NQ, K, 2h, 2h) applied over qx ([[SW, SE], [NW, NE]]).
template <typename T, int HORD>
__global__ void __launch_bounds__(kThreads, single_blocks<T>())
fvtp2d_single_kernel(
    const T* __restrict__ qx, const T* __restrict__ qy, int qy_mode, int h,
    const T* __restrict__ crx, const T* __restrict__ cry,
    const T* __restrict__ xfx, const T* __restrict__ yfx,
    const T* __restrict__ area, const T* __restrict__ mfx,
    const T* __restrict__ mfy, T* __restrict__ fx, T* __restrict__ fy,
    int NQ, int K, int Y, int X) {
  using G = SingleTile;
  constexpr int TY = G::TY, TX = G::TX, NSM = G::NSM;
  extern __shared__ unsigned char smem_raw[];
  // crx, cry, xfx, yfx, area, qx, qy, fx1, fy1
  T* sm = reinterpret_cast<T*>(smem_raw);

  const int tiles_x = (X + TX - 1) / TX;
  const int j0 = (blockIdx.x / tiles_x) * TY;
  const int i0 = (blockIdx.x - (blockIdx.x / tiles_x) * tiles_x) * TX;
  const int s = blockIdx.z / NQ;
  const int X1 = X + 1;
  const int Y1 = Y + 1;
  const long long lev = (long long)s * K + blockIdx.y;
  const long long q = (long long)blockIdx.z * K + blockIdx.y;  // the plane (s, tracer, k)
  __shared__ Window<G> win;
  form_window(win, j0, i0, h, Y, X);
  __syncthreads();

  stage_operands(sm, crx + lev * Y * X1, cry + lev * Y1 * X, xfx + lev * Y * X1,
                 yfx + lev * Y1 * X, area + (long long)s * Y * X, win, X);
  stage_field(sm + 5 * NSM, sm + 6 * NSM, qx + q * Y * X,
              qy + (qy_mode ? q * 4 * h * h : q * Y * X), qy_mode, h, win, X);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  transport_field<T, HORD, G, kSegInSingle, kSegOutSingle, 7>(
      sm, sm + 5 * NSM, sm + 6 * NSM, mfx ? mfx + lev * Y * X1 : nullptr,
      mfy ? mfy + lev * Y1 * X : nullptr, fx + q * Y * X1, fy + q * Y1 * X, j0, i0, Y, X);
}

template <typename T, int HORD>
int launch_single_hord(const void* qx, const void* qy, int qy_mode, int h,
                       const void* crx, const void* cry, const void* xfx,
                       const void* yfx, const void* area, const void* mfx,
                       const void* mfy, void* fx, void* fy, int S, int NQ, int K,
                       int Y, int X, void* stream) {
  using G = SingleTile;
  const int tiles = ((Y + G::TY - 1) / G::TY) * ((X + G::TX - 1) / G::TX);
  const size_t smem = sizeof(T) * kArraysSingle * G::NSM;
  auto kern = fvtp2d_single_kernel<T, HORD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(tiles, K, S * NQ);
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
  if (NQ < 1) return -2;
#define PACE_FVTP2D_ARGS \
  qx, qy, qy_mode, h, crx, cry, xfx, yfx, area, mfx, mfy, fx, fy, S, NQ, K, Y, X, stream
  switch (hord) {
    case 1: return launch_single_hord<T, 1>(PACE_FVTP2D_ARGS);
    case 5:
    case 6: return launch_single_hord<T, 6>(PACE_FVTP2D_ARGS);
    case 7: return launch_single_hord<T, 7>(PACE_FVTP2D_ARGS);
    case 8: return launch_single_hord<T, 8>(PACE_FVTP2D_ARGS);
    default: return -1;
  }
#undef PACE_FVTP2D_ARGS
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

// The tracer block: the arguments of pace_fvtp2d_f32 with qx (S, NQ, K, Y,
// X), qy (S, NQ, K, Y, X) or its corner pack (S, NQ, K, 2h, 2h).
extern "C" int pace_fvtp2d_tracer_f32(const void* qx, const void* qy, int qy_mode,
                                      int h, const void* crx, const void* cry,
                                      const void* xfx, const void* yfx,
                                      const void* area, const void* mfx,
                                      const void* mfy, void* fx, void* fy, int S,
                                      int NQ, int K, int Y, int X, int hord,
                                      void* stream) {
  return launch_tracer<float>(qx, qy, qy_mode, h, crx, cry, xfx, yfx, area, mfx, mfy,
                              fx, fy, S, NQ, K, Y, X, hord, stream);
}

extern "C" int pace_fvtp2d_tracer_f64(const void* qx, const void* qy, int qy_mode,
                                      int h, const void* crx, const void* cry,
                                      const void* xfx, const void* yfx,
                                      const void* area, const void* mfx,
                                      const void* mfy, void* fx, void* fy, int S,
                                      int NQ, int K, int Y, int X, int hord,
                                      void* stream) {
  return launch_tracer<double>(qx, qy, qy_mode, h, crx, cry, xfx, yfx, area, mfx, mfy,
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
