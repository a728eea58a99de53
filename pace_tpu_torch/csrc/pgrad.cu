// Nonhydrostatic D-grid pressure gradient: four A-grid to B-grid
// interpolations and both contour pressure-gradient pairs in one pass.
//
// Replaces pace_tpu/ops/pgrad_pallas.py `_kernel` (with `_a2b_fast`;
// pallas_call at :333). From pk, gz, pp (S, K+1, Y, X), delp (S, K, Y, X)
// and the D-grid winds u (S, K, Y+1, X), v (S, K, Y, X+1) it produces
//   u_new = (u + du_h) + du_p,   v_new = (v + dv_h) + dv_p
// as ops/nonhydro.py nh_p_grad does: du_h is the contour integral of gz
// d(pk) between the corner columns of each D-grid edge, du_p the one of gz
// d(pp) over the corner delp, all on corner values from ops/pgrad.py
// a2b_ord4 (4th-order interpolation, the tile-edge lines' great-circle
// blend with the ghost center interpolated along the edge, the one-sided
// cubic next to each edge, the along-edge interpolation on the S/N edge
// rows, the 3-quadrant extrapolation at cube corners). Each edge correction
// is the plain version's blend x + e (y - x), evaluated where the 0/1 flag
// e is not 0 (elsewhere the blend leaves x as it is); the cube-corner mean
// is a true division by 3 (the plain version's `/ 3.0` is a reciprocal
// multiply on CUDA tensors, 1 ulp apart). Stencil reads clamp at the array
// border where the plain version's pads replicate and its rolls wrap: the
// two agree on every corner whose 4x4 stencil lies inside the array, which
// includes every corner of the compute domain's u and v points.
//
// Bound on an H100: bytes. 3 (K+1)-level fields, delp, u, v in and u, v out
// is about 637 planes, 0.60 GB for a C192 npz=79 f32 call, 0.18 ms at
// 3.35 TB/s; the arithmetic (about 4 x 30 operations per corner and level
// for the interpolations, 2 x 25 per edge for the pairs) is about 0.05 ms at
// 67 TFLOP/s.
// Design: one block per (8 x 32 tile of u/v points, shard) walks the
// levels. For each interface k it forms the x-interface values of the four
// centre planes on the tile's rows and a ring of 2 (stage A, x-taps read
// through L1), the corner values of the tile and one more row and column
// from them (stage B, into a ring of 2 interfaces in shared memory), and
// then the layer k-1 pair from interfaces k-1 and k (stage C). Each
// interface is interpolated once; delp's corner values of layer k wait in
// the slot of interface k. Shared memory: 3960 values (15.8 KB in f32). The
// cube corners on a tile's corner points are listed once per block.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int kThreads = TX * TY;
constexpr int QR = TY + 4;  // x-interface rows staged: j0-2 .. j0+TY+1
constexpr int QC = TX + 1;  // x-interface columns: i0 .. i0+TX
constexpr int BR = TY + 1;  // corner rows of the tile: j0 .. j0+TY
constexpr int BC = TX + 1;  // corner columns: i0 .. i0+TX
constexpr int kMaxTileCorners = 8;  // cube corners a tile's corner points can hold

template <typename T>
struct Args {
  const T* pk;
  const T* gz;
  const T* pp;
  const T* delp;
  const T* u;
  const T* v;
  const T* rdx;    // (S, Y+1, X)
  const T* rdy;    // (S, Y, X+1)
  const T* ew;     // (S, 1, X+1) tile W edge on x-interface i
  const T* ee;     // (S, 1, X+1)
  const T* es;     // (S, Y+1, 1)
  const T* en;     // (S, Y+1, 1)
  const T* glx;    // (S, 1, X+1) 1 where the ghost is left of interface i
  const T* gsy;    // (S, Y+1, 1) 1 where the ghost is south of interface j
  const T* xw0;    // (S, Y, X+1) along-edge ghost weights, W/E lines
  const T* xwp;
  const T* xwm;
  const T* yw0;    // (S, Y+1, X) S/N lines
  const T* ywp;
  const T* ywm;
  T* u_out;
  T* v_out;
};

__device__ __forceinline__ int clampi(int a, int lo, int hi) {
  return a < lo ? lo : (a > hi ? hi : a);
}

// q[r, c] of one (Y, X) plane, indices clamped into the plane
template <typename T>
__device__ __forceinline__ T Q(const T* q, int r, int c, int Y, int X) {
  return __ldg(q + clampi(r, 0, Y - 1) * X + clampi(c, 0, X - 1));
}

// x-interface value at row r (inside the plane), interface i (0..X): the
// 4th-order interpolation with the W/E tile-edge blends of a2b_ord4
template <typename T>
__device__ T x_iface(const Args<T>& A, const T* q, int s, int r, int i, int Y,
                     int X) {
  const int X1 = X + 1;
  const T qm1 = Q(q, r, i - 1, Y, X), q0 = Q(q, r, i, Y, X);
  const T qm2 = Q(q, r, i - 2, Y, X), qp1 = Q(q, r, i + 1, Y, X);
  T val = T(0.5625) * (qm1 + q0) + T(-0.0625) * (qm2 + qp1);
  const T ex = A.ew[s * X1 + i] + A.ee[s * X1 + i];
  if (ex != T(0)) {
    const T gl = A.glx[s * X1 + i];
    const T gr = T(1) - gl;
    const int rp = r + 1 < Y ? r + 1 : r + 1 - Y;  // the plain version's rolls
    const int rm = r - 1 >= 0 ? r - 1 : r - 1 + Y;
    const T g0 = gl * qm1 + gr * q0;
    const T gp = gl * Q(q, rp, i - 1, Y, X) + gr * Q(q, rp, i, Y, X);
    const T gm = gl * Q(q, rm, i - 1, Y, X) + gr * Q(q, rm, i, Y, X);
    const T inside = gl * q0 + gr * qm1;
    const int w = (s * Y + r) * X1 + i;
    const T gt = (A.xw0[w] * g0 + A.xwp[w] * gp) + A.xwm[w] * gm;
    const T qm = T(0.5) * (inside + gt);
    val = val + ex * (qm - val);
  }
  const T in_w = A.ew[s * X1 + (i == 0 ? X : i - 1)];
  const T in_e = A.ee[s * X1 + (i == X ? 0 : i + 1)];
  if (in_w != T(0) || in_e != T(0)) {
    const T os_r = ((T(0.3125) * qm1 + T(0.9375) * q0) - T(0.3125) * qp1) +
                   T(0.0625) * Q(q, r, i + 2, Y, X);
    const T os_l = ((T(0.3125) * q0 + T(0.9375) * qm1) - T(0.3125) * qm2) +
                   T(0.0625) * Q(q, r, i - 3, Y, X);
    const T a = in_w * (os_r - val);
    const T b = in_e * (os_l - val);
    val = (val + a) + b;
  }
  return val;
}

// y-interface value at interface row j (0..Y), column c (inside the plane),
// with the S/N tile-edge blends; called on S/N edge rows only
template <typename T>
__device__ T y_iface(const Args<T>& A, const T* q, int s, int j, int c, int Y,
                     int X) {
  const int Y1 = Y + 1;
  const T qm1 = Q(q, j - 1, c, Y, X), q0 = Q(q, j, c, Y, X);
  const T qm2 = Q(q, j - 2, c, Y, X), qp1 = Q(q, j + 1, c, Y, X);
  T val = T(0.5625) * (qm1 + q0) + T(-0.0625) * (qm2 + qp1);
  const T ey = A.es[s * Y1 + j] + A.en[s * Y1 + j];
  if (ey != T(0)) {
    const T gs = A.gsy[s * Y1 + j];
    const T gn = T(1) - gs;
    const int cp = c + 1 < X ? c + 1 : c + 1 - X;
    const int cm = c - 1 >= 0 ? c - 1 : c - 1 + X;
    const T g0 = gs * qm1 + gn * q0;
    const T gp = gs * Q(q, j - 1, cp, Y, X) + gn * Q(q, j, cp, Y, X);
    const T gm = gs * Q(q, j - 1, cm, Y, X) + gn * Q(q, j, cm, Y, X);
    const T inside = gs * q0 + gn * qm1;
    const int w = (s * Y1 + j) * X + c;
    const T gt = (A.yw0[w] * g0 + A.ywp[w] * gp) + A.ywm[w] * gm;
    const T qm = T(0.5) * (inside + gt);
    val = val + ey * (qm - val);
  }
  const T in_s = A.es[s * Y1 + (j == 0 ? Y : j - 1)];
  const T in_n = A.en[s * Y1 + (j == Y ? 0 : j + 1)];
  if (in_s != T(0) || in_n != T(0)) {
    const T os_n = ((T(0.3125) * qm1 + T(0.9375) * q0) - T(0.3125) * qp1) +
                   T(0.0625) * Q(q, j + 2, c, Y, X);
    const T os_s = ((T(0.3125) * q0 + T(0.9375) * qm1) - T(0.3125) * qm2) +
                   T(0.0625) * Q(q, j - 3, c, Y, X);
    const T a = in_s * (os_n - val);
    const T b = in_n * (os_s - val);
    val = (val + a) + b;
  }
  return val;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) pgrad_kernel(
    Args<T> A, T dt, const int* __restrict__ pos, const int* __restrict__ quad,
    const int* __restrict__ own, int n_corners, int S, int K, int Y, int X,
    int tiles_x) {
  __shared__ T qx_s[4][QR][QC];
  __shared__ T b_s[2][4][BR][BC];
  __shared__ int s_corner[kMaxTileCorners];
  __shared__ int s_ncorner;

  const int s = blockIdx.y;
  const int j0 = (blockIdx.x / tiles_x) * TY;
  const int i0 = (blockIdx.x % tiles_x) * TX;
  const int tid = threadIdx.x;
  const long long P = (long long)Y * X;
  const int X1 = X + 1;

  // the cube corners this shard owns on the tile's corner points, found
  // once: most tiles have none, and the corner loop of stage B runs over
  // this list only
  if (tid == 0) {
    int m = 0;
    for (int c = 0; c < n_corners && m < kMaxTileCorners; ++c) {
      const int cj = pos[2 * c], ci = pos[2 * c + 1];
      if (own[c * S + s] && cj >= j0 && cj <= j0 + TY && ci >= i0 && ci <= i0 + TX)
        s_corner[m++] = c;
    }
    s_ncorner = m;
  }
  __syncthreads();

  for (int k = 0; k <= K; ++k) {
    const int nf = k < K ? 4 : 3;  // delp has K levels
    const T* planes[4] = {A.pk + ((long long)s * (K + 1) + k) * P,
                          A.gz + ((long long)s * (K + 1) + k) * P,
                          A.pp + ((long long)s * (K + 1) + k) * P,
                          A.delp + ((long long)s * K + (k < K ? k : 0)) * P};
    // stage A: x-interface values on rows j0-2 .. j0+TY+1 (clamped)
    for (int idx = tid; idx < nf * QR * QC; idx += kThreads) {
      const int f = idx / (QR * QC);
      const int rl = (idx / QC) % QR;
      const int il = idx % QC;
      const int i = i0 + il;
      if (i > X) continue;
      const int r = clampi(j0 - 2 + rl, 0, Y - 1);
      qx_s[f][rl][il] = x_iface(A, planes[f], s, r, i, Y, X);
    }
    __syncthreads();
    // stage B: corner values of interface k into slot k & 1
    const int slot = k & 1;
    for (int idx = tid; idx < nf * BR * BC; idx += kThreads) {
      const int f = idx / (BR * BC);
      const int jl = (idx / BC) % BR;
      const int il = idx % BC;
      const int j = j0 + jl, i = i0 + il;
      if (j > Y || i > X) continue;
      const T* q = planes[f];
      T val = T(0.5625) * (qx_s[f][jl + 1][il] + qx_s[f][jl + 2][il]) +
              T(-0.0625) * (qx_s[f][jl][il] + qx_s[f][jl + 3][il]);
      const T ey = A.es[s * (Y + 1) + j] + A.en[s * (Y + 1) + j];
      if (ey != T(0)) {
        // along the S/N edge row: 4th-order interpolation of its
        // y-interface values
        const T ym1 = y_iface(A, q, s, j, clampi(i - 1, 0, X - 1), Y, X);
        const T y0 = y_iface(A, q, s, j, clampi(i, 0, X - 1), Y, X);
        const T ym2 = y_iface(A, q, s, j, clampi(i - 2, 0, X - 1), Y, X);
        const T yp1 = y_iface(A, q, s, j, clampi(i + 1, 0, X - 1), Y, X);
        const T out_y = T(0.5625) * (ym1 + y0) + T(-0.0625) * (ym2 + yp1);
        val = val + ey * (out_y - val);
      }
      for (int m = 0; m < s_ncorner; ++m) {
        const int c = s_corner[m];
        if (pos[2 * c] != j || pos[2 * c + 1] != i) continue;
        // cube corner: mean of the 3 one-sided diagonal quadratic
        // extrapolations; a corner beyond the last cell row/column reads 0,
        // other indices wrap
        T acc = T(0);
        for (int qd = 0; qd < 3; ++qd) {
          const int a = quad[c * 6 + 2 * qd], b = quad[c * 6 + 2 * qd + 1];
          T cell[3];
          for (int d = 0; d < 3; ++d) {
            const int aa = a >= 0 ? a + d : a - d;
            const int bb = b >= 0 ? b + d : b - d;
            cell[d] = T(0);
            if (j < Y && i < X) {
              const int r = ((j + aa) % Y + Y) % Y;
              const int cl = ((i + bb) % X + X) % X;
              cell[d] = q[r * X + cl];
            }
          }
          const T ext = (T(1.875) * cell[0] - T(1.25) * cell[1]) + T(0.375) * cell[2];
          acc = qd == 0 ? ext : acc + ext;
        }
        val = acc / T(3);
      }
      b_s[slot][f][jl][il] = val;
    }
    __syncthreads();
    if (k == 0) continue;
    // stage C: layer kk = k-1 from interfaces kk (slot a) and k (slot b)
    const int kk = k - 1, a = kk & 1, b = k & 1;
    const int jl = tid / TX, il = tid % TX;
    const int j = j0 + jl, i = i0 + il;
    if (j <= Y && i < X) {  // u point (j, i): corners (j, i) and (j, i+1)
      const T p1k = b_s[a][0][jl][il], p1kp = b_s[b][0][jl][il];
      const T p2k = b_s[a][0][jl][il + 1], p2kp = b_s[b][0][jl][il + 1];
      const T g1k = b_s[a][1][jl][il], g1kp = b_s[b][1][jl][il];
      const T g2k = b_s[a][1][jl][il + 1], g2kp = b_s[b][1][jl][il + 1];
      const T q1k = b_s[a][2][jl][il], q1kp = b_s[b][2][jl][il];
      const T q2k = b_s[a][2][jl][il + 1], q2kp = b_s[b][2][jl][il + 1];
      const T dp1 = b_s[a][3][jl][il], dp2 = b_s[a][3][jl][il + 1];
      const T dtr = A.rdx[((long long)s * (Y + 1) + j) * X + i] * dt;
      const T term_h = (g1kp - g2k) * (p2kp - p1k) + (g1k - g2kp) * (p1kp - p2k);
      const T du_h = dtr * term_h / ((p1kp - p1k) + (p2kp - p2k));
      const T term_p = (g1kp - g2k) * (q2kp - q1k) + (g1k - g2kp) * (q1kp - q2k);
      const T du_p = dtr * term_p / (dp1 + dp2);
      const long long o = (((long long)s * K + kk) * (Y + 1) + j) * X + i;
      A.u_out[o] = (A.u[o] + du_h) + du_p;
    }
    if (j < Y && i <= X) {  // v point (j, i): corners (j, i) and (j+1, i)
      const T p1k = b_s[a][0][jl][il], p1kp = b_s[b][0][jl][il];
      const T p2k = b_s[a][0][jl + 1][il], p2kp = b_s[b][0][jl + 1][il];
      const T g1k = b_s[a][1][jl][il], g1kp = b_s[b][1][jl][il];
      const T g2k = b_s[a][1][jl + 1][il], g2kp = b_s[b][1][jl + 1][il];
      const T q1k = b_s[a][2][jl][il], q1kp = b_s[b][2][jl][il];
      const T q2k = b_s[a][2][jl + 1][il], q2kp = b_s[b][2][jl + 1][il];
      const T dp1 = b_s[a][3][jl][il], dp2 = b_s[a][3][jl + 1][il];
      const T dtr = A.rdy[((long long)s * Y + j) * X1 + i] * dt;
      const T term_h = (g1kp - g2k) * (p2kp - p1k) + (g1k - g2kp) * (p1kp - p2k);
      const T dv_h = dtr * term_h / ((p1kp - p1k) + (p2kp - p2k));
      const T term_p = (g1kp - g2k) * (q2kp - q1k) + (g1k - g2kp) * (q1kp - q2k);
      const T dv_p = dtr * term_p / (dp1 + dp2);
      const long long o = (((long long)s * K + kk) * Y + j) * X1 + i;
      A.v_out[o] = (A.v[o] + dv_h) + dv_p;
    }
  }
}

template <typename T>
int launch(const void* const* p, double dt, const int* pos, const int* quad,
           const int* own, int n_corners, int S, int K, int Y, int X,
           void* stream) {
  Args<T> A;
  const T** in = reinterpret_cast<const T**>(&A);
  for (int n = 0; n < 20; ++n) in[n] = (const T*)p[n];
  A.u_out = (T*)p[20];
  A.v_out = (T*)p[21];
  const int tiles_x = (X + 1 + TX - 1) / TX;
  const int tiles_y = (Y + 1 + TY - 1) / TY;
  dim3 grid(tiles_x * tiles_y, S);
  pgrad_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      A, (T)dt, pos, quad, own, n_corners, S, K, Y, X, tiles_x);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: pk, gz, pp, delp, u, v, then the 14 grid arrays in the order of
// Args (rdx, rdy, edge_w/e/s/n_iface, a2b_ghost_left_x, a2b_ghost_south_y,
// a2b_x_w0/wp/wm, a2b_y_w0/wp/wm), then u_out, v_out: 22 device pointers in
// a host array. pos (n_corners, 2), quad (n_corners, 3, 2) and own
// (n_corners, S) are int32 device arrays.
extern "C" int pace_pgrad_f32(const void* const* ptrs, double dt, const int* pos,
                              const int* quad, const int* own, int n_corners,
                              int S, int K, int Y, int X, void* stream) {
  return launch<float>(ptrs, dt, pos, quad, own, n_corners, S, K, Y, X, stream);
}

extern "C" int pace_pgrad_f64(const void* const* ptrs, double dt, const int* pos,
                              const int* quad, const int* own, int n_corners,
                              int S, int K, int Y, int X, void* stream) {
  return launch<double>(ptrs, dt, pos, quad, own, n_corners, S, K, Y, X, stream);
}
