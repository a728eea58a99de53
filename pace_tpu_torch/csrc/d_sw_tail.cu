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
// Design: one block per (16x32 slot tile, level, shard). The hard part is
// the nord loop: after nord Laplacians the potential at one corner depends
// on divg nord corners away in every direction, and the outputs of a tile
// read the potential on the tile plus one corner line. So the block stages
// divg on the tile plus a ring of nord (+1 on the high side) in shared
// memory and iterates the Laplacian there between two buffers on a region
// that shrinks by one ring per pass; then it forms chi and dtke on the
// tile's (TY+1) x (TX+1) corners in shared memory, and last the three
// outputs per slot. Device memory sees each field once plus the ring
// overlap of divg (1.75x at nord 3); the constant planes are re-read per
// level (they fit in L2). The cube-corner fix is a branch on the corner's
// coordinates against a table of at most a handful of points.

#include <cuda_runtime.h>

namespace {

constexpr int TY = 16;
constexpr int TX = 32;
constexpr int RMAX = 3;           // largest nord
constexpr int DY = TY + 1 + 2 * RMAX;  // staged divg rows j0-3 .. j0+TY+3
constexpr int DX = TX + 1 + 2 * RMAX;
constexpr int ND = DY * DX;
constexpr int CY = TY + 1;  // chi / dtke rows j0 .. j0+TY
constexpr int CX = TX + 1;
constexpr int NC = CY * CX;
constexpr int kThreads = 256;

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

template <typename T>
__device__ __forceinline__ T vmin(T a, T b) { return a < b ? a : b; }
template <typename T>
__device__ __forceinline__ T vmax(T a, T b) { return a > b ? a : b; }
__device__ __forceinline__ float vsqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ double vsqrt(double a) { return sqrt(a); }

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

template <typename T>
__global__ void __launch_bounds__(kThreads) d_sw_tail_kernel(
    Args<T> A, Params<T> P, const int* __restrict__ pos,
    const int* __restrict__ quad, const int* __restrict__ own, int n_corners,
    int S, int K, int Y, int X) {
  extern __shared__ unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* s_d[2] = {sm, sm + ND};  // divg and its Laplacian iterates
  T* s_chi = sm + 2 * ND;
  T* s_dtke = sm + 2 * ND + NC;

  const int X1 = X + 1;
  const int Y1 = Y + 1;
  const int tiles_x = (X1 + TX - 1) / TX;
  const int j0 = (blockIdx.x / tiles_x) * TY;
  const int i0 = (blockIdx.x % tiles_x) * TX;
  const int k = blockIdx.y;
  const int s = blockIdx.z;
  const long long lev = (long long)s * K + k;

  const long long fc = lev * Y * X, fx = lev * Y * X1, fy = lev * Y1 * X,
                  fn = lev * Y1 * X1;
  const long long cc = (long long)s * Y * X, cx = (long long)s * Y * X1,
                  cy = (long long)s * Y1 * X, cn = (long long)s * Y1 * X1;
  const T *u = A.u + fy, *v = A.v + fx, *ut = A.ut + fx, *vt = A.vt + fy,
          *divg = A.divg + fn, *vort = A.vort + fc, *vfx = A.vfx + fx,
          *vfy = A.vfy + fy;
  const T* dvfx = A.dvfx ? A.dvfx + fx : nullptr;
  const T* dvfy = A.dvfy ? A.dvfy + fy : nullptr;
  const T *dx = A.dx + cy, *rdx = A.rdx + cy, *dy = A.dy + cx, *rdy = A.rdy + cx,
          *rsin2 = A.rsin2 + cc, *cosa_s = A.cosa_s + cc, *f0 = A.f0 + cc,
          *wgx = A.wgx + cy, *wgy = A.wgy + cx, *rarea_c = A.rarea_c + cn,
          *edge_s = A.edge_s + (long long)s * Y1, *edge_n = A.edge_n + (long long)s * Y1,
          *edge_w = A.edge_w + (long long)s * X1, *edge_e = A.edge_e + (long long)s * X1;
  const int nord = P.nord;

  // --- stage divg on the chi region plus a ring of nord
  if (nord > 0) {
    for (int idx = threadIdx.x; idx < ND; idx += kThreads) {
      const int a = idx / DX;
      const int b = idx - a * DX;
      const int ring_a = a < RMAX ? RMAX - a : a - (RMAX + TY);  // <= 0 inside
      const int ring_b = b < RMAX ? RMAX - b : b - (RMAX + TX);
      if (ring_a > nord || ring_b > nord) continue;
      const int j = j0 - RMAX + a;
      const int i = i0 - RMAX + b;
      if (j < 0 || i < 0 || j > Y || i > X) continue;
      s_d[0][idx] = divg[j * X1 + i];
    }
    __syncthreads();
  }

  // --- nord Laplacians (ops/delnflux.py lap_corner, times da_min_c), pass n
  //     on the chi region plus a ring of nord - n
  for (int n = 1; n <= nord; ++n) {
    const T* src = s_d[(n - 1) & 1];
    T* dst = s_d[n & 1];
    const int ring = nord - n;
    const int rows = TY + 1 + 2 * ring, cols = TX + 1 + 2 * ring;
    for (int idx = threadIdx.x; idx < rows * cols; idx += kThreads) {
      const int a = idx / cols + (RMAX - ring);
      const int b = idx % cols + (RMAX - ring);
      const int j = j0 - RMAX + a;
      const int i = i0 - RMAX + b;
      if (j < 0 || i < 0 || j > Y || i > X) continue;
      // gx[m] joins corners (j, m) and (j, m+1); right and left of corner i
      // are gx[min(i, X-1)] and gx[max(i-1, 0)], the pads' clamps
      const int mr = hi(i, X), ml = lo(i), nr = hi(j, Y), nl = lo(j);
      const int row = a * DX - (i0 - RMAX);       // + column index
      const int col = b - (j0 - RMAX) * DX;       // + row index * DX
      const T gxr = (src[row + mr + 1] - src[row + mr]) * wgx[j * X + mr];
      const T gxl = (src[row + ml + 1] - src[row + ml]) * wgx[j * X + ml];
      const T gyr = (src[(nr + 1) * DX + col] - src[nr * DX + col]) * wgy[nr * X1 + i];
      const T gyl = (src[(nl + 1) * DX + col] - src[nl * DX + col]) * wgy[nl * X1 + i];
      const T lap = (((gxr - gxl) + gyr) - gyl) * rarea_c[j * X1 + i];
      dst[a * DX + b] = lap * P.da_min_c;
    }
    __syncthreads();
  }
  const T* s_dn = s_d[nord & 1];

  // --- chi and dtke on the tile's corners and one more line
  for (int idx = threadIdx.x; idx < NC; idx += kThreads) {
    const int a = idx / CX;
    const int b = idx - a * CX;
    const int j = j0 + a;
    const int i = i0 + b;
    if (j > Y || i > X) continue;
    const int jl = lo(j), jr = hi(j, Y), il = lo(i), ir = hi(i, X);
    // kinetic energy
    const T ub = T(0.5) * (ut[jl * X1 + i] + ut[jr * X1 + i]);
    const T vb = T(0.5) * (vt[j * X + il] + vt[j * X + ir]);
    const T u_up = ub > T(0) ? u[j * X + il] : u[j * X + ir];
    const T v_up = vb > T(0) ? v[jl * X1 + i] : v[jr * X1 + i];
    T ke = T(0.5) * (ub * u_up + vb * v_up);
    for (int c = 0; c < n_corners; ++c) {
      if (pos[2 * c] != j || pos[2 * c + 1] != i || !own[c * S + s]) continue;
      // cube corner: the mean cell energy of the three real quadrants; a
      // corner beyond the last cell row/column reads 0, other indices wrap
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
      ke = acc / T(3.0);
    }
    // damping potential
    const T dv = divg[j * X1 + i];
    T damp2 = A.d2_col[k];
    if (P.use_smag) {
      const T zeta_c =
          T(0.25) * ((((vort[jl * X + il] - f0[jl * X + il]) +
                       (vort[jl * X + ir] - f0[jl * X + ir])) +
                      (vort[jr * X + il] - f0[jr * X + il])) +
                     (vort[jr * X + ir] - f0[jr * X + ir]));
      const T smag = P.dt * vsqrt(dv * dv + zeta_c * zeta_c);
      damp2 = vmax(damp2, vmin(P.dddmp * smag, T(0.20)));
    }
    T chi = P.da_min_c * damp2 * dv;
    if (nord > 0) {
      const T chin = P.dampn * s_dn[(a + RMAX) * DX + (b + RMAX)];
      if (P.use_band) {
        const T band = vmin(
            vmax(((edge_s[j] + edge_n[j]) + edge_w[i]) + edge_e[i], T(0)), T(1));
        chi = (chi + (T(1) - band) * chin) + band * (P.dmin_edge * dv);
      } else {
        chi = chi + chin;
      }
    }
    s_chi[idx] = chi;
    s_dtke[idx] = P.dt * ke - chi;
  }
  __syncthreads();

  // --- the outputs of the tile's slots
  const bool has_vd = dvfx != nullptr;
  for (int idx = threadIdx.x; idx < TY * TX; idx += kThreads) {
    const int a = idx / TX;
    const int b = idx - a * TX;
    const int j = j0 + a;
    const int i = i0 + b;
    if (j > Y || i > X) continue;
    const int m = a * CX + b;
    const bool row_c = j < Y;
    const bool col_c = i < X;
    if (col_c) {  // u point (j, i)
      const int g = j * X + i;
      T f = vfy[g];
      if (has_vd) f = f + dvfy[g];
      A.u_new[fy + g] = ((u[g] * dx[g] + (s_dtke[m] - s_dtke[m + 1])) + f) * rdx[g];
    }
    if (row_c) {  // v point (j, i)
      const int g = j * X1 + i;
      T f = vfx[g];
      if (has_vd) f = f + dvfx[g];
      A.v_new[fx + g] = ((v[g] * dy[g] + (s_dtke[m] - s_dtke[m + CX])) - f) * rdy[g];
    }
    if (A.heat && row_c && col_c) {
      // damping-only wind increments on the cell's four edges
      T e_u[2], e_v[2];
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const int gu = (j + d) * X + i;   // u point (j+d, i)
        const int mu = (a + d) * CX + b;
        T du = (s_chi[mu + 1] - s_chi[mu]) * rdx[gu];
        if (has_vd) du = du + dvfy[gu] * rdx[gu];
        e_u[d] = (u[gu] + T(0.5) * du) * du;
        const int gv = j * X1 + i + d;    // v point (j, i+d)
        const int mv = a * CX + b + d;
        T dw = (s_chi[mv + CX] - s_chi[mv]) * rdy[gv];
        if (has_vd) dw = dw - dvfx[gv] * rdy[gv];
        e_v[d] = (v[gv] + T(0.5) * dw) * dw;
      }
      A.heat[fc + j * X + i] =
          -(T(0.5) * (e_u[0] + e_u[1]) + T(0.5) * (e_v[0] + e_v[1]));
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
  const size_t smem = sizeof(T) * (2 * ND + 2 * NC);
  auto kern = d_sw_tail_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(tiles, K, S);
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
