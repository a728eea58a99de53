// The C-grid shallow-water half step after d2a2c and its halo exchanges,
// fused in one kernel (plus a point kernel for the cube corners).
//
// Replaces pace_tpu/ops/c_sw_tail_pallas.py `_kernel` / `_tail_math`
// (pallas_call at :256, entry c_sw_tail_pallas :272): contravariant C
// winds, upwind area fluxes, the provisional first-order delp/pt transport,
// kinetic energy and absolute vorticity, the momentum update of uc/vc, and
// the corner divergence of the D-grid winds with its one-sided tile-edge
// form. 14 fields in, 9 out, 23 constant planes. Arithmetic follows
// pace_tpu_torch/ops/c_sw.py (c_sw_tail_plain) op for op; built with
// -fmad=false it rounds like the plain PyTorch version. Like the TPU kernel
// it skips dedup_corner_divergence: the 3-quadrant average overwrites the
// same cube-corner points.
//
// Four staggerings: cell (Y, X), x-interface (Y, X+1), y-interface (Y+1, X)
// and corner (Y+1, X+1). The plain version's cell->interface helpers
// replicate the edge value beyond the plane; here every such read clamps
// its index the same way, so the kernel equals the plain version on the
// whole plane, not only on the consumed region.
//
// Bound on an H100: bytes. About 150 flops per slot and level against 23
// field values moved (~1.7 GB, ~0.51 ms at 3.35 TB/s for a C192 npz=79 f32
// call; ~0.04 ms of arithmetic at 67 TFLOP/s).
// Design: one block per (16x32 slot tile, level, shard). Stage A computes
// the twelve intermediates that neighbours share (ut, vt, xfx, yfx, the
// upwind fluxes fx1/fy1 and their pt-weighted forms, ke, vorticity, the
// divergence legs uf/vf) on the tile plus a one-slot ring, straight from
// global memory, into shared memory; stage B combines them into the nine
// outputs. Device memory sees each field once plus the ring overlap
// (1.2x); the constant planes are re-read per level (they fit in L2).
// The cube-corner points (a handful per shard) are patched by a second,
// tiny launch that reads xfx/yfx back: one thread per (corner, level,
// shard).

#include <cuda_runtime.h>

namespace {

constexpr int TY = 16;
constexpr int TX = 32;
constexpr int RY = TY + 2;  // region rows j0-1 .. j0+TY
constexpr int RX = TX + 2;
constexpr int NR = RY * RX;
constexpr int kArrays = 12;
constexpr int kThreads = 256;

template <typename T>
struct Args {
  // fields, (S, K, ., .)
  const T *u, *v, *delp, *pt, *uc, *vc, *uc_x, *vc_x, *uc_y, *vc_y, *ua, *va,
      *va_x, *ua_y;
  // constants, (S, ., .)
  const T *cosa_u, *rsin_u2, *cosa_v, *rsin_v2, *dx, *dy, *sin_sg_e, *sin_sg_w,
      *sin_sg_n, *sin_sg_s, *rarea, *dxc, *dyc, *rarea_c, *fC, *sina_u, *sina_v,
      *rdxc, *rdyc, *uedge_w, *vedge_w, *edge_y, *edge_x;
  // outputs
  T *delpc, *ptc, *uc_new, *vc_new, *ut, *vt, *xfx, *yfx, *divg;
};

__device__ __forceinline__ int lo(int a) { return a > 0 ? a - 1 : 0; }         // max(a-1, 0)
__device__ __forceinline__ int hi(int a, int n) { return a < n ? a : n - 1; }  // min(a, n-1)

template <typename T>
__global__ void __launch_bounds__(kThreads) c_sw_tail_kernel(Args<T> A, T dt2,
                                                             int K, int Y, int X) {
  extern __shared__ unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* s_ut = sm;
  T* s_vt = sm + NR;
  T* s_xfx = sm + 2 * NR;
  T* s_yfx = sm + 3 * NR;
  T* s_fx1 = sm + 4 * NR;
  T* s_fxp = sm + 5 * NR;  // pt_x * fx1
  T* s_fy1 = sm + 6 * NR;
  T* s_fyp = sm + 7 * NR;
  T* s_ke = sm + 8 * NR;
  T* s_vort = sm + 9 * NR;
  T* s_uf = sm + 10 * NR;
  T* s_vf = sm + 11 * NR;

  const int X1 = X + 1;
  const int Y1 = Y + 1;
  const int tiles_x = (X1 + TX - 1) / TX;
  const int j0 = (blockIdx.x / tiles_x) * TY;
  const int i0 = (blockIdx.x % tiles_x) * TX;
  const int k = blockIdx.y;
  const int s = blockIdx.z;
  const long long lev = (long long)s * K + k;

  // level planes of the fields, shard planes of the constants
  const long long fc = lev * Y * X, fx = lev * Y * X1, fy = lev * Y1 * X;
  const long long cc = (long long)s * Y * X, cx = (long long)s * Y * X1,
                  cy = (long long)s * Y1 * X, cn = (long long)s * Y1 * X1;
  const T *u = A.u + fy, *v = A.v + fx, *delp = A.delp + fc, *pt = A.pt + fc,
          *uc = A.uc + fx, *vc = A.vc + fy, *uc_x = A.uc_x + fx,
          *vc_x = A.vc_x + fy, *uc_y = A.uc_y + fx, *vc_y = A.vc_y + fy,
          *ua = A.ua + fc, *va = A.va + fc, *va_x = A.va_x + fc,
          *ua_y = A.ua_y + fc;
  const T *cosa_u = A.cosa_u + cx, *rsin_u2 = A.rsin_u2 + cx,
          *cosa_v = A.cosa_v + cy, *rsin_v2 = A.rsin_v2 + cy, *dx = A.dx + cy,
          *dy = A.dy + cx, *sin_sg_e = A.sin_sg_e + cc,
          *sin_sg_w = A.sin_sg_w + cc, *sin_sg_n = A.sin_sg_n + cc,
          *sin_sg_s = A.sin_sg_s + cc, *rarea = A.rarea + cc, *dxc = A.dxc + cx,
          *dyc = A.dyc + cy, *rarea_c = A.rarea_c + cn, *fC = A.fC + cn,
          *sina_u = A.sina_u + cx, *sina_v = A.sina_v + cy, *rdxc = A.rdxc + cx,
          *rdyc = A.rdyc + cy, *uedge_w = A.uedge_w + cy,
          *vedge_w = A.vedge_w + cx, *edge_y = A.edge_y + (long long)s * Y1,
          *edge_x = A.edge_x + (long long)s * X1;

  // --- stage A: shared intermediates on the tile plus a one-slot ring
  for (int idx = threadIdx.x; idx < NR; idx += kThreads) {
    const int a = idx / RX;
    const int b = idx - a * RX;
    const int j = j0 - 1 + a;
    const int i = i0 - 1 + b;
    if (j < 0 || i < 0 || j > Y || i > X) continue;
    const bool row_c = j < Y;  // a cell / x-interface row
    const bool col_c = i < X;  // a cell / y-interface column
    if (row_c) {  // x-interface point (j, i), i in [0, X]
      const int il = lo(i), ir = hi(i, X);
      const T cell_l = vc_x[j * X + il] + vc_x[(j + 1) * X + il];
      const T cell_r = vc_x[j * X + ir] + vc_x[(j + 1) * X + ir];
      const T vc4 = T(0.25) * (cell_l + cell_r);
      const int m = j * X1 + i;
      const T ut = (uc_x[m] - cosa_u[m] * vc4) * rsin_u2[m];
      const T xfx = dt2 * ut * dy[m] *
                    (ut > T(0) ? sin_sg_e[j * X + il] : sin_sg_w[j * X + ir]);
      const bool up = xfx > T(0);
      const T fx1 = (up ? delp[j * X + il] : delp[j * X + ir]) * xfx;
      s_ut[idx] = ut;
      s_xfx[idx] = xfx;
      s_fx1[idx] = fx1;
      s_fxp[idx] = (up ? pt[j * X + il] : pt[j * X + ir]) * fx1;
      // +y normal flux through the dual edge crossing the v point
      const T ua_c = T(0.5) * (ua_y[j * X + il] + ua_y[j * X + ir]);
      T vf = (v[m] - ua_c * cosa_u[m]) * sina_u[m] * dxc[m];
      if (edge_x[i] > T(0)) vf = v[m] * vedge_w[m];
      s_vf[idx] = vf;
    }
    if (col_c) {  // y-interface point (j, i), j in [0, Y]
      const int jl = lo(j), jr = hi(j, Y);
      const T cell_l = uc_y[jl * X1 + i] + uc_y[jl * X1 + i + 1];
      const T cell_r = uc_y[jr * X1 + i] + uc_y[jr * X1 + i + 1];
      const T uc4 = T(0.25) * (cell_l + cell_r);
      const int m = j * X + i;
      const T vt = (vc_y[m] - cosa_v[m] * uc4) * rsin_v2[m];
      const T yfx = dt2 * vt * dx[m] *
                    (vt > T(0) ? sin_sg_n[jl * X + i] : sin_sg_s[jr * X + i]);
      const bool up = yfx > T(0);
      const T fy1 = (up ? delp[jl * X + i] : delp[jr * X + i]) * yfx;
      s_vt[idx] = vt;
      s_yfx[idx] = yfx;
      s_fy1[idx] = fy1;
      s_fyp[idx] = (up ? pt[jl * X + i] : pt[jr * X + i]) * fy1;
      const T va_c = T(0.5) * (va_x[jl * X + i] + va_x[jr * X + i]);
      T uf = (u[m] - va_c * cosa_v[m]) * sina_v[m] * dyc[m];
      if (edge_y[j] > T(0)) uf = u[m] * uedge_w[m];
      s_uf[idx] = uf;
    }
    if (row_c && col_c) {  // kinetic energy at cell (j, i)
      const int m = j * X + i;
      const T a_u = ua[m], a_v = va[m];
      const T uc_up = a_u > T(0) ? uc[j * X1 + i] : uc[j * X1 + i + 1];
      const T vc_up = a_v > T(0) ? vc[m] : vc[m + X];
      s_ke[idx] = T(0.5) * (a_u * uc_up + a_v * vc_up);
    }
    {  // absolute vorticity at corner (j, i)
      const int jl = lo(j), jr = hi(j, Y), il = lo(i), ir = hi(i, X);
      const T circ = uc[jl * X1 + i] * dxc[jl * X1 + i] -
                     uc[jr * X1 + i] * dxc[jr * X1 + i] +
                     vc[j * X + ir] * dyc[j * X + ir] -
                     vc[j * X + il] * dyc[j * X + il];
      s_vort[idx] = circ * rarea_c[j * X1 + i] + fC[j * X1 + i];
    }
  }
  __syncthreads();

  // --- stage B: the nine outputs on the tile's slots
  for (int idx = threadIdx.x; idx < TY * TX; idx += kThreads) {
    const int a = idx / TX + 1;
    const int b = idx - (a - 1) * TX + 1;
    const int j = j0 - 1 + a;
    const int i = i0 - 1 + b;
    if (j > Y || i > X) continue;
    const int m = a * RX + b;
    const bool row_c = j < Y;
    const bool col_c = i < X;
    // region offsets of the clamped neighbours
    const int m_il = a * RX + (lo(i) - (i0 - 1));     // (j, max(i-1, 0))
    const int m_ir = a * RX + (hi(i, X) - (i0 - 1));  // (j, min(i, X-1))
    const int m_jl = (lo(j) - (j0 - 1)) * RX + b;     // (max(j-1, 0), i)
    const int m_jr = (hi(j, Y) - (j0 - 1)) * RX + b;  // (min(j, Y-1), i)
    if (row_c && col_c) {
      const int g = j * X + i;
      const T dp = delp[g], ra = rarea[g];
      const T dpc = dp + ((s_fx1[m] - s_fx1[m + 1]) + (s_fy1[m] - s_fy1[m + RX])) * ra;
      A.delpc[fc + g] = dpc;
      A.ptc[fc + g] =
          (pt[g] * dp + ((s_fxp[m] - s_fxp[m + 1]) + (s_fyp[m] - s_fyp[m + RX])) * ra) / dpc;
    }
    if (row_c) {  // x-interface outputs at (j, i)
      const int g = j * X1 + i;
      const T cell_l = s_vt[m_il] + s_vt[m_il + RX];
      const T cell_r = s_vt[m_ir] + s_vt[m_ir + RX];
      const T v_n = T(0.25) * (cell_l + cell_r) * sina_u[g];
      const T zeta = v_n > T(0) ? s_vort[m] : s_vort[m + RX];
      const T ke_gx = (s_ke[m_il] - s_ke[m_ir]) * rdxc[g];
      A.uc_new[fx + g] = uc[g] + dt2 * (zeta * v_n + ke_gx);
      A.ut[fx + g] = s_ut[m];
      A.xfx[fx + g] = s_xfx[m];
    }
    if (col_c) {  // y-interface outputs at (j, i)
      const int g = j * X + i;
      const T cell_l = s_ut[m_jl] + s_ut[m_jl + 1];
      const T cell_r = s_ut[m_jr] + s_ut[m_jr + 1];
      const T u_n = T(0.25) * (cell_l + cell_r) * sina_v[g];
      const T zeta = u_n > T(0) ? s_vort[m] : s_vort[m + 1];
      const T ke_gy = (s_ke[m_jl] - s_ke[m_jr]) * rdyc[g];
      A.vc_new[fy + g] = vc[g] + dt2 * (-zeta * u_n + ke_gy);
      A.vt[fy + g] = s_vt[m];
      A.yfx[fy + g] = s_yfx[m];
    }
    {  // corner divergence at (j, i)
      const T out = (s_uf[m_ir] - s_uf[m_il]) + (s_vf[m_jr] - s_vf[m_jl]);
      A.divg[lev * Y1 * X1 + j * X1 + i] = out * rarea_c[j * X1 + i];
    }
  }
}

// Cube corners: divg <- mean cell divergence of the three real quadrants,
// on the shards that own the corner. quad[c * 6 + 2 * q + {0, 1}] are the
// (row, column) offsets of corner c's real quadrant q; a corner beyond the
// last cell row/column reads 0, other cell indices wrap.
template <typename T>
__global__ void c_sw_corner_kernel(const T* __restrict__ xfx,
                                   const T* __restrict__ yfx,
                                   const T* __restrict__ rarea,
                                   T* __restrict__ divg,
                                   const int* __restrict__ pos,
                                   const int* __restrict__ quad,
                                   const int* __restrict__ own, int n_corners,
                                   T dt2, int S, int K, int Y, int X) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= n_corners * S * K) return;
  const int c = tid / (S * K);
  const int sk = tid - c * (S * K);
  const int s = sk / K;
  if (!own[c * S + s]) return;
  const int jj = pos[2 * c], ii = pos[2 * c + 1];
  const int X1 = X + 1, Y1 = Y + 1;
  const T* xf = xfx + (long long)sk * Y * X1;
  const T* yf = yfx + (long long)sk * Y1 * X;
  const T* ra = rarea + (long long)s * Y * X;
  T acc = T(0);
  for (int q = 0; q < 3; ++q) {
    T val = T(0);
    if (jj < Y && ii < X) {
      const int r = ((jj + quad[c * 6 + 2 * q]) % Y + Y) % Y;
      const int cl = ((ii + quad[c * 6 + 2 * q + 1]) % X + X) % X;
      val = -((xf[r * X1 + cl] - xf[r * X1 + cl + 1]) +
              (yf[r * X + cl] - yf[(r + 1) * X + cl])) *
            ra[r * X + cl] / dt2;
    }
    acc = q == 0 ? val : acc + val;
  }
  divg[(long long)sk * Y1 * X1 + jj * X1 + ii] = acc / T(3.0);
}

template <typename T>
int launch(const void* const* p, double dt2, const int* pos, const int* quad,
           const int* own, int n_corners, int S, int K, int Y, int X,
           void* stream) {
  Args<T> A;
  const T** in = reinterpret_cast<const T**>(&A);
  for (int n = 0; n < 37; ++n) in[n] = (const T*)p[n];
  T** out = reinterpret_cast<T**>(&A) + 37;
  for (int n = 0; n < 9; ++n) out[n] = (T*)p[37 + n];

  const int tiles = ((Y + 1 + TY - 1) / TY) * ((X + 1 + TX - 1) / TX);
  const size_t smem = sizeof(T) * kArrays * NR;
  auto kern = c_sw_tail_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(tiles, K, S);
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(A, (T)dt2, K, Y, X);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_corners == 0) return (int)err;
  const int n = n_corners * S * K;
  c_sw_corner_kernel<T><<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      A.xfx, A.yfx, A.rarea, A.divg, pos, quad, own, n_corners, (T)dt2, S, K, Y, X);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: the 14 fields (u, v, delp, pt, uc, vc, uc_x, vc_x, uc_y, vc_y, ua,
// va, va_x, ua_y), the 23 constants in the order of Args, then the 9 outputs
// (46 device pointers in a host array). pos (n_corners, 2), quad
// (n_corners, 3, 2) and own (n_corners, S) are int32 device arrays.
extern "C" int pace_c_sw_tail_f32(const void* const* ptrs, double dt2,
                                  const int* pos, const int* quad,
                                  const int* own, int n_corners, int S, int K,
                                  int Y, int X, void* stream) {
  return launch<float>(ptrs, dt2, pos, quad, own, n_corners, S, K, Y, X, stream);
}

extern "C" int pace_c_sw_tail_f64(const void* const* ptrs, double dt2,
                                  const int* pos, const int* quad,
                                  const int* own, int n_corners, int S, int K,
                                  int Y, int X, void* stream) {
  return launch<double>(ptrs, dt2, pos, quad, own, n_corners, S, K, Y, X, stream);
}
