// The D-grid shallow-water step after its transport fluxes, fused in one
// kernel: kinetic energy at corners, the divergence-damping potential, the
// circulation-form momentum update and the dissipation estimate.
//
// Replaces pace_tpu/ops/d_sw_tail_pallas.py `_kernel` / `_tail_math`
// (pallas_call at :253, entry d_sw_tail_pallas :275). Per level:
//   ke    = 0.5 (ub u_up + vb v_up) at corners (contravariant B-grid wind
//           times the upwinded covariant edge wind); at the cube corners a
//           shard owns, the mean cell energy of the three real quadrants
//   damp2 = max(d2_col[k], min(0.2, dddmp dt sqrt(divg^2 + zeta_c^2)))
//   chi   = da_min_c damp2 divg
//           + [nord > 0] dampn (-1)^nord (da_min_c rarea_c Lap)^nord divg,
//           on tile-edge corner lines replaced by a del-2 term (the band)
//   dtke  = dt ke - chi
//   u_new = (u dx + (dtke[i] - dtke[i+1]) + vfy) rdx     (v_new alike)
//   heat  = -(mean of e_u over the cell's two x-edges + mean of e_v over its
//           two y-edges), e = (wind + du/2) du of the damping-only increment
// in the operation order of pace_tpu_torch/ops/d_sw.py (d_sw_tail_plain);
// built with -fmad=false it rounds like the plain PyTorch version. Every
// cell-to-interface read clamps at the plane's border as the plain version's
// edge-replicating pads do, so the two agree on the whole plane.
//
// Four staggerings: cell (Y, X), x-interface (Y, X+1), y-interface (Y+1, X)
// and corner (Y+1, X+1). In: u, vt, vfy, dvfy (y-interface), v, ut, vfx,
// dvfx (x-interface), divg (corner), vort (cell). Out: u_new, v_new, heat.
//
// Bound on an H100: bytes. 10 fields in and 3 out per level (~0.97 GB,
// ~0.29 ms at 3.35 TB/s for a C192 npz=79 f32 call) against about 120
// operations per point at nord 3 (~0.03 ms at 67 TFLOP/s).
// Design: one block per (8 x 40 slot tile, run of 8 levels, shard), 256
// threads, four blocks an SM. What holds such a tail is issuing the loads
// and arithmetic, not device memory: every corner and slot reads a dozen
// neighbours of several fields. So every stencil read comes from shared
// memory, through one base pointer and constant offsets (few live
// registers):
// - The constant planes the stencils read (the Laplacian weights wgx, wgy
//   and rarea_c on the divg ring, f0 on the field window, dx, rdx, dy, rdy
//   and the edge band on the tile's corners) are staged once per block by
//   cp.async and serve all its levels.
// - The fields of level k + 1 (divg on the ring of nord, u, v, ut, vt and
//   the vorticity on the tile plus one line) arrive by cp.async into the
//   second buffer while level k is computed. The windows are staged with
//   the plain version's clamps, so the passes read them without any; a
//   thread keeps one column of a window and walks its rows, so a copy costs
//   an address and no division.
// - Per level: the first nord - 1 Laplacians of divg on a region that
//   shrinks by one ring a pass (the first also forms vort - f0 once per
//   cell, in place); then chi and dtke on the tile's corners, the last
//   Laplacian formed there; then the outputs of its slots with a warp's
//   lanes on consecutive slots: four barriers at nord 3. vfx, vfy and the
//   vorticity damping fluxes, read at a slot or its neighbour only, come from
//   device memory in that last pass, coalesced. Blocks whose Laplacian
//   region stays a line inside the plane take a path without the border
//   clamps.
// - Cube corners: a block learns once whether its tile holds one of the
//   shard's cube corners; only such blocks walk the corner table, after the
//   chi pass, and form dtke there again.
// - The 8 x 40 tile cuts the 199 x 199 slot plane into 25 x 5 tiles with
//   under 1% of the slots idle (16 x 32: 13 x 7 with 15% idle).
// Tile shape, levels a block and blocks an SM were chosen by timing the
// candidates on an H100 (tools/torch_kernel_variants.py, PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int TY = 8;       // slot rows of a tile
constexpr int TX = 40;      // slot columns of a tile
constexpr int kLevels = 8;  // levels a block walks
constexpr int kThreads = 256;  // threads a block
constexpr int RMAX = 3;                 // largest nord
constexpr int DY = TY + 1 + 2 * RMAX;   // divg ring: rows j0-3 .. j0+TY+3
constexpr int DX = TX + 1 + 2 * RMAX;
constexpr int ND = DY * DX;
constexpr int CY = TY + 1;  // the tile's corners: rows j0 .. j0+TY
constexpr int CX = TX + 1;
constexpr int NC = CY * CX;
constexpr int WY = TY + 2;  // field window: rows j0-1 .. j0+TY
constexpr int WX = TX + 2;
constexpr int NW = WY * WX;
// one level's staged fields: divg on its ring, then u, v, ut, vt and the
// vorticity on the window
constexpr int LV_DIVG = 0, LV_U = ND, LV_V = ND + NW, LV_UT = ND + 2 * NW,
              LV_VT = ND + 3 * NW, LV_VORT = ND + 4 * NW;
constexpr int kLevelVals = ND + 5 * NW;
// shared memory, in values of T: the Laplacian weights and rarea_c on the
// ring, the band, dx, rdx, dy, rdy on the corners, f0 on the window, two
// level buffers, two Laplacian iterates, chi and dtke
constexpr int OFF_WGX = 0, OFF_WGY = ND, OFF_RAC = 2 * ND, OFF_BAND = 3 * ND,
              OFF_DX = OFF_BAND + NC, OFF_RDX = OFF_DX + NC, OFF_DY = OFF_RDX + NC,
              OFF_RDY = OFF_DY + NC, OFF_F0 = OFF_RDY + NC, OFF_LEV = OFF_F0 + NW,
              OFF_L0 = OFF_LEV + 2 * kLevelVals, OFF_L1 = OFF_L0 + ND, OFF_CHI = OFF_L1 + ND,
              OFF_DTKE = OFF_CHI + NC;
constexpr int kSmemVals = OFF_DTKE + NC;
// staging: a thread keeps one column of the window (of the ring) and takes
// every kWinRows-th (kRingRows-th) row
constexpr int kWinRows = kThreads / WX;
constexpr int kRingRows = kThreads / DX;

// Blocks per SM the kernel is compiled for (shared memory allows four of
// float, two of double).
template <typename T>
constexpr int tail_blocks() {
  return sizeof(T) == 8 ? 2 : 4;
}

template <typename T>
struct Args {
  // fields, (S, K, ., .); dvfx, dvfy null without vorticity damping
  const T *u, *v, *ut, *vt, *divg, *vort, *vfx, *vfy, *dvfx, *dvfy;
  // constant planes (S, ., .), the four tile-edge flag vectors and d2_col (K)
  const T *dx, *rdx, *dy, *rdy, *rsin2, *cosa_s, *f0, *wgx, *wgy, *rarea_c,
      *edge_s, *edge_n, *edge_w, *edge_e, *d2_col;
  // outputs; heat null when the dissipation estimate is not asked for
  T *u_new, *v_new, *heat;
};

template <typename T>
struct Params {
  T dt, dddmp, da_min_c;
  T dampn;     // d4_bg^(nord+1) da_min_c (-1)^nord
  T dmin_edge; // da_min_c max(d4_bg / 3, d2_bg)
  int nord, use_smag, use_band;
};

__device__ __forceinline__ int lo(int a) { return a > 0 ? a - 1 : 0; }         // max(a-1, 0)
__device__ __forceinline__ int hi(int a, int n) { return a < n ? a : n - 1; }  // min(a, n-1)
__device__ __forceinline__ int clampi(int a, int n) { return a < 0 ? 0 : (a < n ? a : n - 1); }

template <typename T>
__device__ __forceinline__ T vmin(T a, T b) { return a < b ? a : b; }
template <typename T>
__device__ __forceinline__ T vmax(T a, T b) { return a > b ? a : b; }
__device__ __forceinline__ float vsqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ double vsqrt(double a) { return sqrt(a); }

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
               "n"(sizeof(T)));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// A ring array (rows j0-RMAX.., columns i0-RMAX..) of a plane of nr x nc
// values, where it lies on the plane (once per block).
template <typename T>
__device__ __forceinline__ void stage_ring(T* dst, const T* __restrict__ src, int nr, int nc,
                                           int j0, int i0) {
  for (int idx = threadIdx.x; idx < ND; idx += kThreads) {
    const int a = idx / DX;
    const int j = j0 - RMAX + a;
    const int i = i0 - RMAX + idx - a * DX;
    if (j >= 0 && i >= 0 && j < nr && i < nc) cp_async(dst + idx, src + j * nc + i);
  }
}

// The tile's corners (rows j0 .. j0+TY, columns i0 .. i0+TX) of a plane,
// where they lie on it (once per block).
template <typename T>
__device__ __forceinline__ void stage_corners(T* dst, const T* __restrict__ src, int nr, int nc,
                                              int j0, int i0) {
  for (int idx = threadIdx.x; idx < NC; idx += kThreads) {
    const int a = idx / CX;
    const int j = j0 + a;
    const int i = i0 + idx - a * CX;
    if (j < nr && i < nc) cp_async(dst + idx, src + j * nc + i);
  }
}

// e_cell of d_sw.kinetic_energy_corners at cell (r, c)
template <typename T>
__device__ __forceinline__ T cell_energy(const T* u, const T* v, const T* cosa_s,
                                         const T* rsin2, int r, int c, int X) {
  const T u_cov = T(0.5) * (u[r * X + c] + u[(r + 1) * X + c]);
  const T v_cov = T(0.5) * (v[r * (X + 1) + c] + v[r * (X + 1) + c + 1]);
  const T cs = cosa_s[r * X + c], rs = rsin2[r * X + c];
  const T ua_c = (u_cov - v_cov * cs) * rs;
  const T va_c = (v_cov - u_cov * cs) * rs;
  return T(0.5) * (ua_c * u_cov + va_c * v_cov);
}

// The cube-corner fix of dtke: for each entry of the corner table that
// names a corner (j, i) of this block's tile for shard s, the kinetic
// energy there is the mean cell energy of its three real quadrants (a
// corner beyond the last cell row/column reads 0, other indices wrap), and
// dtke = dt ke - chi is formed again with it. One thread walks the table in
// order (a later entry for the same corner wins, as in the plain version);
// only the blocks whose tile holds such a corner call it.
template <typename T>
__device__ void fix_cube_corners(T* sm, const T* u, const T* v, const T* cosa_s,
                                 const T* rsin2, const int* __restrict__ pos,
                                 const int* __restrict__ quad, const int* __restrict__ own,
                                 int n_corners, int S, int s, int j0, int i0, int Y, int X,
                                 T dt) {
  if (threadIdx.x != 0) return;
  for (int c = 0; c < n_corners; ++c) {
    const int j = pos[2 * c], i = pos[2 * c + 1];
    if (!own[c * S + s] || j < j0 || j > j0 + TY || i < i0 || i > i0 + TX || j > Y || i > X)
      continue;
    T acc = T(0);
    for (int q = 0; q < 3; ++q) {
      T val = T(0);
      if (j < Y && i < X) {
        const int r = ((j + quad[c * 6 + 2 * q]) % Y + Y) % Y;
        const int cl = ((i + quad[c * 6 + 2 * q + 1]) % X + X) % X;
        val = cell_energy(u, v, cosa_s, rsin2, r, cl, X);
      }
      acc = q == 0 ? val : acc + val;
    }
    const T ke = acc / T(3.0);
    const int idx = (j - j0) * CX + (i - i0);
    sm[OFF_DTKE + idx] = dt * ke - sm[OFF_CHI + idx];
  }
}

// da_min_c times the Laplacian (ops/delnflux.py lap_corner) of the ring
// array at sm + src, at ring position (a, b), corner (j, i) of the plane.
// INTERIOR: (j, i) is at least one corner line away from the plane's
// border, where the clamps below are the identity.
template <typename T, bool INTERIOR>
__device__ __forceinline__ T lap_at(const T* sm, int src, int a, int b, int j, int i, int j0,
                                    int i0, int Y, int X, T da_min_c) {
  const int m = a * DX + b;
  T gxr, gxl, gyr, gyl;
  if constexpr (INTERIOR) {
    gxr = (sm[src + m + 1] - sm[src + m]) * sm[OFF_WGX + m];
    gxl = (sm[src + m] - sm[src + m - 1]) * sm[OFF_WGX + m - 1];
    gyr = (sm[src + m + DX] - sm[src + m]) * sm[OFF_WGY + m];
    gyl = (sm[src + m] - sm[src + m - DX]) * sm[OFF_WGY + m - DX];
  } else {
    // gx[m] joins corners (j, m) and (j, m+1); right and left of corner i
    // are gx[min(i, X-1)] and gx[max(i-1, 0)], the pads' clamps
    const int mr = hi(i, X) - (i0 - RMAX), ml = lo(i) - (i0 - RMAX);  // ring columns
    const int nr = hi(j, Y) - (j0 - RMAX), nl = lo(j) - (j0 - RMAX);  // ring rows
    const int row = a * DX;
    gxr = (sm[src + row + mr + 1] - sm[src + row + mr]) * sm[OFF_WGX + row + mr];
    gxl = (sm[src + row + ml + 1] - sm[src + row + ml]) * sm[OFF_WGX + row + ml];
    gyr = (sm[src + (nr + 1) * DX + b] - sm[src + nr * DX + b]) * sm[OFF_WGY + nr * DX + b];
    gyl = (sm[src + (nl + 1) * DX + b] - sm[src + nl * DX + b]) * sm[OFF_WGY + nl * DX + b];
  }
  const T lap = (((gxr - gxl) + gyr) - gyl) * sm[OFF_RAC + m];
  return lap * da_min_c;
}

// One Laplacian pass on the tile's corners plus a ring of RING lines, from
// the ring array at sm + src into sm + dst
template <typename T, int RING, bool INTERIOR>
__device__ __forceinline__ void lap_pass(T* sm, int src, int dst, T da_min_c, int j0, int i0,
                                         int Y, int X) {
  constexpr int rows = TY + 1 + 2 * RING, cols = TX + 1 + 2 * RING;
  for (int idx = threadIdx.x; idx < rows * cols; idx += kThreads) {
    const int a = idx / cols + (RMAX - RING);
    const int b = idx % cols + (RMAX - RING);
    const int j = j0 - RMAX + a;
    const int i = i0 - RMAX + b;
    if (!INTERIOR && (j < 0 || i < 0 || j > Y || i > X)) continue;
    sm[dst + a * DX + b] = lap_at<T, INTERIOR>(sm, src, a, b, j, i, j0, i0, Y, X, da_min_c);
  }
}

template <typename T, int RING>
__device__ __forceinline__ void lap_pass(T* sm, int src, int dst, T da_min_c, int j0, int i0,
                                         int Y, int X, bool interior) {
  if (interior)
    lap_pass<T, RING, true>(sm, src, dst, da_min_c, j0, i0, Y, X);
  else
    lap_pass<T, RING, false>(sm, src, dst, da_min_c, j0, i0, Y, X);
}

// Grid: x = tile, y = run of kLevels levels, z = shard.
template <typename T>
__global__ void __launch_bounds__(kThreads, tail_blocks<T>()) d_sw_tail_kernel(
    Args<T> A, Params<T> P, const int* __restrict__ pos,
    const int* __restrict__ quad, const int* __restrict__ own, int n_corners,
    int S, int K, int Y, int X) {
  extern __shared__ unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  __shared__ int s_has_corner;

  const int X1 = X + 1;
  const int Y1 = Y + 1;
  const int tiles_x = (X1 + TX - 1) / TX;
  const int j0 = (blockIdx.x / tiles_x) * TY;
  const int i0 = (blockIdx.x - (blockIdx.x / tiles_x) * tiles_x) * TX;
  const int k0 = blockIdx.y * kLevels;
  const int k1 = min(K, k0 + kLevels);
  const int s = blockIdx.z;
  const int nord = P.nord;
  const int tid = threadIdx.x;
  // every corner the Laplacians reach (a ring of RMAX - 1 around the
  // tile's) at least one line inside the plane's border
  const bool interior = j0 - (RMAX - 1) >= 1 && i0 - (RMAX - 1) >= 1 &&
                        j0 + TY + (RMAX - 1) <= Y - 1 && i0 + TX + (RMAX - 1) <= X - 1;

  // --- the shard's constant planes, once for all the block's levels
  const long long cc = (long long)s * Y * X, cx = (long long)s * Y * X1,
                  cy = (long long)s * Y1 * X, cn = (long long)s * Y1 * X1;
  if (nord > 0) {
    stage_ring(sm + OFF_WGX, A.wgx + cy, Y1, X, j0, i0);
    stage_ring(sm + OFF_WGY, A.wgy + cx, Y, X1, j0, i0);
    stage_ring(sm + OFF_RAC, A.rarea_c + cn, Y1, X1, j0, i0);
  }
  stage_corners(sm + OFF_DX, A.dx + cy, Y1, X, j0, i0);
  stage_corners(sm + OFF_RDX, A.rdx + cy, Y1, X, j0, i0);
  stage_corners(sm + OFF_DY, A.dy + cx, Y, X1, j0, i0);
  stage_corners(sm + OFF_RDY, A.rdy + cx, Y, X1, j0, i0);
  if (P.use_smag && tid < kWinRows * WX) {
    const T* f0 = A.f0 + cc;
    const int wb = tid % WX, wcX = clampi(i0 - 1 + wb, X);
    for (int a = tid / WX; a < WY; a += kWinRows)
      cp_async(sm + OFF_F0 + a * WX + wb, f0 + clampi(j0 - 1 + a, Y) * X + wcX);
  }
  if (nord > 0 && P.use_band) {
    const T *es = A.edge_s + (long long)s * Y1, *en = A.edge_n + (long long)s * Y1,
            *ew = A.edge_w + (long long)s * X1, *ee = A.edge_e + (long long)s * X1;
    for (int idx = tid; idx < NC; idx += kThreads) {
      const int a = idx / CX;
      const int j = j0 + a;
      const int i = i0 + idx - a * CX;
      if (j <= Y && i <= X)
        sm[OFF_BAND + idx] = vmin(vmax(((es[j] + en[j]) + ew[i]) + ee[i], T(0)), T(1));
    }
  }
  if (tid == 0) {
    int has = 0;
    for (int c = 0; c < n_corners; ++c) {
      const int pj = pos[2 * c], pi = pos[2 * c + 1];
      if (own[c * S + s] && pj >= j0 && pj <= j0 + TY && pi >= i0 && pi <= i0 + TX) has = 1;
    }
    s_has_corner = has;
  }

  // --- one level's fields into level buffer lb by cp.async: divg on the
  //     ring of nord (the tile's corners at nord 0), the rest on the window
  //     with the pads' clamps; one commit group. A thread keeps one
  //     column of the window (of the ring).
  auto stage_level = [&](int k, int lb) {
    const long long lev = (long long)s * K + k;
    if (tid < kWinRows * WX) {
      const int wb = tid % WX;
      const int wcX = clampi(i0 - 1 + wb, X), wcX1 = clampi(i0 - 1 + wb, X1);
      const T* u = A.u + lev * Y1 * X;
      const T* v = A.v + lev * Y * X1;
      const T* ut = A.ut + lev * Y * X1;
      const T* vt = A.vt + lev * Y1 * X;
      for (int a = tid / WX; a < WY; a += kWinRows) {
        const int jr = j0 - 1 + a;
        const int oA = clampi(jr, Y1) * X + wcX;   // (Y+1, X): u, vt
        const int oB = clampi(jr, Y) * X1 + wcX1;  // (Y, X+1): v, ut
        T* d = sm + lb + a * WX + wb;
        cp_async(d + LV_U, u + oA);
        cp_async(d + LV_V, v + oB);
        cp_async(d + LV_UT, ut + oB);
        cp_async(d + LV_VT, vt + oA);
        if (P.use_smag) cp_async(d + LV_VORT, A.vort + lev * Y * X + clampi(jr, Y) * X + wcX);
      }
    }
    const int rb = tid % DX;
    const int ri = i0 - RMAX + rb;
    const int ring_b = rb < RMAX ? RMAX - rb : rb - (RMAX + TX);  // <= 0 inside
    if (tid < kRingRows * DX && ring_b <= nord && ri >= 0 && ri <= X) {
      const T* divg = A.divg + lev * Y1 * X1 + ri;
      for (int a = tid / DX; a < DY; a += kRingRows) {
        const int j = j0 - RMAX + a;
        const int ring_a = a < RMAX ? RMAX - a : a - (RMAX + TY);
        if (ring_a <= nord && j >= 0 && j <= Y)
          cp_async(sm + lb + LV_DIVG + a * DX + rb, divg + j * X1);
      }
    }
    cp_async_commit();
  };
  stage_level(k0, OFF_LEV);

  const bool has_vd = A.dvfx != nullptr;
  // the Laplacian iterate the chi pass differentiates last (nord >= 1)
  const int chi_src = nord >= 3 ? OFF_L1 : OFF_L0;
  for (int k = k0; k < k1; ++k) {
    const int lb = OFF_LEV + ((k - k0) & 1) * kLevelVals;
    cp_async_wait_all();
    __syncthreads();
    if (k + 1 < k1) stage_level(k + 1, OFF_LEV + ((k + 1 - k0) & 1) * kLevelVals);
    const long long lev = (long long)s * K + k;

    // --- the first nord - 1 Laplacians on a shrinking region (the last one
    //     is the chi pass's); the relative vorticity vort - f0 of each cell
    //     of the window, once, in place, with the first
    const bool z_pass = P.use_smag != 0;
    const int npass = nord > 1 ? nord - 1 : (z_pass ? 1 : 0);
    for (int n = 1; n <= npass; ++n) {
      if (n == 1 && z_pass)
        for (int idx = tid; idx < NW; idx += kThreads)
          sm[lb + LV_VORT + idx] = sm[lb + LV_VORT + idx] - sm[OFF_F0 + idx];
      if (n < nord) {
        const int src = n == 1 ? lb + LV_DIVG : OFF_L0;
        const int dst = n == 1 ? OFF_L0 : OFF_L1;
        if (nord - n == 2)
          lap_pass<T, 2>(sm, src, dst, P.da_min_c, j0, i0, Y, X, interior);
        else
          lap_pass<T, 1>(sm, src, dst, P.da_min_c, j0, i0, Y, X, interior);
      }
      __syncthreads();
    }
    const int src_last = nord == 1 ? lb + LV_DIVG : chi_src;

    // --- chi and dtke on the tile's corners
    const T d2 = A.d2_col[k];
    for (int idx = tid; idx < NC; idx += kThreads) {
      const int a = idx / CX;
      const int b = idx - a * CX;
      const int j = j0 + a;
      const int i = i0 + b;
      if (j > Y || i > X) continue;
      const int w = lb + (a + 1) * WX + (b + 1);  // the window's (j, i); - WX: j - 1, - 1: i - 1
      // kinetic energy
      const T ub = T(0.5) * (sm[w + LV_UT - WX] + sm[w + LV_UT]);
      const T vb = T(0.5) * (sm[w + LV_VT - 1] + sm[w + LV_VT]);
      const T u_up = ub > T(0) ? sm[w + LV_U - 1] : sm[w + LV_U];
      const T v_up = vb > T(0) ? sm[w + LV_V - WX] : sm[w + LV_V];
      const T ke = T(0.5) * (ub * u_up + vb * v_up);
      // damping potential
      const int r = (a + RMAX) * DX + (b + RMAX);  // the ring's (j, i)
      const T dv = sm[lb + LV_DIVG + r];
      T damp2 = d2;
      if (z_pass) {
        const T zeta_c = T(0.25) * (((sm[w + LV_VORT - WX - 1] + sm[w + LV_VORT - WX]) +
                                     sm[w + LV_VORT - 1]) + sm[w + LV_VORT]);
        const T smag = P.dt * vsqrt(dv * dv + zeta_c * zeta_c);
        damp2 = vmax(damp2, vmin(P.dddmp * smag, T(0.20)));
      }
      T chi = P.da_min_c * damp2 * dv;
      if (nord > 0) {
        const T lap = interior ? lap_at<T, true>(sm, src_last, a + RMAX, b + RMAX, j, i, j0,
                                                 i0, Y, X, P.da_min_c)
                               : lap_at<T, false>(sm, src_last, a + RMAX, b + RMAX, j, i, j0,
                                                  i0, Y, X, P.da_min_c);
        const T chin = P.dampn * lap;
        if (P.use_band) {
          const T band = sm[OFF_BAND + idx];
          chi = (chi + (T(1) - band) * chin) + band * (P.dmin_edge * dv);
        } else {
          chi = chi + chin;
        }
      }
      sm[OFF_CHI + idx] = chi;
      sm[OFF_DTKE + idx] = P.dt * ke - chi;
    }
    __syncthreads();
    if (s_has_corner) {  // the same for every thread of the block
      fix_cube_corners(sm, A.u + lev * Y1 * X, A.v + lev * Y * X1, A.cosa_s + cc,
                       A.rsin2 + cc, pos, quad, own, n_corners, S, s, j0, i0, Y, X, P.dt);
      __syncthreads();
    }

    // --- the outputs of the tile's slots, a warp's lanes on consecutive slots
    const long long fc = lev * Y * X, fx = lev * Y * X1, fy = lev * Y1 * X;
    for (int idx = tid; idx < TY * TX; idx += kThreads) {
      const int a = idx / TX;
      const int b = idx - a * TX;
      const int j = j0 + a;
      const int i = i0 + b;
      if (j > Y || i > X) continue;
      const int m = a * CX + b;
      const int w = lb + (a + 1) * WX + (b + 1);
      const bool row_c = j < Y;
      const bool col_c = i < X;
      if (col_c) {  // u point (j, i)
        const long long g = fy + j * X + i;
        T f = A.vfy[g];
        if (has_vd) f = f + A.dvfy[g];
        A.u_new[g] = ((sm[w + LV_U] * sm[OFF_DX + m] +
                       (sm[OFF_DTKE + m] - sm[OFF_DTKE + m + 1])) + f) * sm[OFF_RDX + m];
      }
      if (row_c) {  // v point (j, i)
        const long long g = fx + j * X1 + i;
        T f = A.vfx[g];
        if (has_vd) f = f + A.dvfx[g];
        A.v_new[g] = ((sm[w + LV_V] * sm[OFF_DY + m] +
                       (sm[OFF_DTKE + m] - sm[OFF_DTKE + m + CX])) - f) * sm[OFF_RDY + m];
      }
      if (A.heat && row_c && col_c) {
        // damping-only wind increments on the cell's four edges
        T e_u[2], e_v[2];
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          const int mu = m + d * CX;  // u point (j+d, i)
          T du = (sm[OFF_CHI + mu + 1] - sm[OFF_CHI + mu]) * sm[OFF_RDX + mu];
          if (has_vd) du = du + A.dvfy[fy + (j + d) * X + i] * sm[OFF_RDX + mu];
          e_u[d] = (sm[w + LV_U + d * WX] + T(0.5) * du) * du;
          const int mv = m + d;       // v point (j, i+d)
          T dw = (sm[OFF_CHI + mv + CX] - sm[OFF_CHI + mv]) * sm[OFF_RDY + mv];
          if (has_vd) dw = dw - A.dvfx[fx + j * X1 + i + d] * sm[OFF_RDY + mv];
          e_v[d] = (sm[w + LV_V + d] + T(0.5) * dw) * dw;
        }
        A.heat[fc + j * X + i] =
            -(T(0.5) * (e_u[0] + e_u[1]) + T(0.5) * (e_v[0] + e_v[1]));
      }
    }
  }
}

template <typename T>
int launch(const void* const* p, const double* prm, int nord, int use_smag,
           int use_band, const int* pos, const int* quad, const int* own,
           int n_corners, int S, int K, int Y, int X, void* stream) {
  if (nord < 0 || nord > RMAX) return -1;
  Args<T> A;
  const T** in = reinterpret_cast<const T**>(&A);
  for (int n = 0; n < 25; ++n) in[n] = (const T*)p[n];
  T** out = reinterpret_cast<T**>(&A) + 25;
  for (int n = 0; n < 3; ++n) out[n] = (T*)p[25 + n];
  Params<T> P;
  P.dt = (T)prm[0];
  P.dddmp = (T)prm[1];
  P.da_min_c = (T)prm[2];
  P.dampn = (T)prm[3];
  P.dmin_edge = (T)prm[4];
  P.nord = nord;
  P.use_smag = use_smag;
  P.use_band = use_band;

  const int tiles = ((Y + 1 + TY - 1) / TY) * ((X + 1 + TX - 1) / TX);
  const size_t smem = sizeof(T) * kSmemVals;
  auto kern = d_sw_tail_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(tiles, (K + kLevels - 1) / kLevels, S);
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(A, P, pos, quad, own,
                                                       n_corners, S, K, Y, X);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: the 10 fields (u, v, ut, vt, divg, vort, vfx, vfy, dvfx, dvfy; the
// last two null without vorticity damping), the 15 constants in the order
// of Args, then the 3 outputs (heat null when not asked for): 28 device
// pointers in a host array. prm: host array (dt, dddmp, da_min_c, dampn,
// dmin_edge). pos (n_corners, 2), quad (n_corners, 3, 2) and own
// (n_corners, S) are int32 device arrays.
extern "C" int pace_d_sw_tail_f32(const void* const* ptrs, const double* prm,
                                  int nord, int use_smag, int use_band,
                                  const int* pos, const int* quad,
                                  const int* own, int n_corners, int S, int K,
                                  int Y, int X, void* stream) {
  return launch<float>(ptrs, prm, nord, use_smag, use_band, pos, quad, own,
                       n_corners, S, K, Y, X, stream);
}

extern "C" int pace_d_sw_tail_f64(const void* const* ptrs, const double* prm,
                                  int nord, int use_smag, int use_band,
                                  const int* pos, const int* quad,
                                  const int* own, int n_corners, int S, int K,
                                  int Y, int X, void* stream) {
  return launch<double>(ptrs, prm, nord, use_smag, use_band, pos, quad, own,
                        n_corners, S, K, Y, X, stream);
}
