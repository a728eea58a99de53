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
// Design: one block of 256 threads per (16 x 32 tile of u/v points, shard,
// chunk of levels) walks the chunk's interfaces. The raw centre planes of
// interface k+1 (pk, gz, pp, delp on the tile and a ring of 2, reads clamped
// into the plane) are copied into one slot of a two-slot ring in shared
// memory with cp.async while interface k is computed from the other slot:
// stage A forms the x-interface values on the tile's rows and a ring of 2,
// stage B the corner values of the tile and one more row and column (into a
// ring of two interfaces), stage C the layer pair k-1 from interfaces k-1
// and k. The taps come from shared memory, so each input byte leaves device
// memory once per block. Each block classifies its tile once
// (ops/pgrad_kernel.py tile_classes): a tile that meets no W/E/S/N tile-edge
// line (nor the first line inside one) and holds no cube corner takes a path
// with no blends and no flag or ghost-weight reads, 55 of the 91 tiles of a
// C192 shard. The others stage the tile's edge vectors and the ghost weights
// of its edge column and row once per block and give the blends items of
// their own: the x-interface values of the blended columns, the S/N edge
// row's y-interface values (formed once per level, not four times per
// corner), and the cube corners; only taps that wrap around the plane read
// device memory. The levels are cut into as many chunks as keep the card's
// block slots evenly filled (each chunk forms its first interface once
// more). Shared memory: 13,433 values (54 KB in f32) and 64 registers a
// thread: four blocks, 1024 threads, an SM.
// What holds it (NVIDIA H100 80GB HBM3, C192 npz=79 f32): instruction issue,
// with three barriers a level and four true divisions a wind point and level
// in the pair stage; it moves its bound's bytes at about a quarter of the
// card's memory rate (tools/torch_kernel_ab.py, PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 16;
constexpr int kThreads = 256;
constexpr int NP = 4;               // pk, gz, pp, delp
constexpr int HR = 2;               // ring of centre cells staged around the tile
constexpr int SR = TY + 2 * HR;     // staged rows: j0-2 .. j0+TY+1
constexpr int SC = TX + 2 * HR;     // staged columns: i0-2 .. i0+TX+1
constexpr int QR = TY + 4;          // x-interface rows: j0-2 .. j0+TY+1
constexpr int QC = TX + 1;          // x-interface columns: i0 .. i0+TX
constexpr int BR = TY + 1;          // corner rows of the tile: j0 .. j0+TY
constexpr int BC = TX + 1;          // corner columns: i0 .. i0+TX
constexpr int YC = TX + 4;          // y-interface columns of an S/N edge row: i0-2 .. i0+TX+1
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

// shared memory of a block: offsets, in values of T, of
constexpr int kRaw = 0;                      // [2][NP][SR][SC] staged centre planes
constexpr int kQx = kRaw + 2 * NP * SR * SC; // [NP][QR][QC] x-interface values
constexpr int kBs = kQx + NP * QR * QC;      // [2][NP][BR][BC] corners of two interfaces
constexpr int kEx = kBs + 2 * NP * BR * BC;  // [QC] ew + ee on x-interface i0+il
constexpr int kGlx = kEx + QC;               // [QC]
constexpr int kInw = kGlx + QC;              // [QC] the W edge left of i (one-sided cubic)
constexpr int kIne = kInw + QC;              // [QC]
constexpr int kXany = kIne + QC;             // [QC] 1 where any W/E blend applies
constexpr int kEy = kXany + QC;              // [BR] es + en on corner row j0+jl
constexpr int kGsy = kEy + BR;               // [BR]
constexpr int kIns = kGsy + BR;              // [BR]
constexpr int kInn = kIns + BR;              // [BR]
constexpr int kXw = kInn + BR;               // [3][QR] ghost weights of the W/E edge column
constexpr int kYw = kXw + 3 * QR;            // [3][YC] ghost weights of the S/N edge row
constexpr int kYq = kYw + 3 * YC;            // [NP][YC] that row's y-interface values
constexpr int kValues = kYq + NP * YC;

__device__ __forceinline__ int clampi(int a, int lo, int hi) {
  return a < lo ? lo : (a > hi ? hi : a);
}

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

// The tile's view of one centre plane: the staged window, with device
// memory for the taps outside it (the blends' outermost taps and those
// that wrap around the plane)
template <typename T>
struct Plane {
  const T* win;  // [SR][SC], row 0 = plane row j0-2, column 0 = i0-2
  const T* g;    // the plane in device memory
  int j0, i0, Y, X;
  // q[r, c] with indices clamped into the plane
  __device__ __forceinline__ T operator()(int r, int c) const {
    r = clampi(r, 0, Y - 1);
    c = clampi(c, 0, X - 1);
    const int lr = r - (j0 - HR), lc = c - (i0 - HR);
    if (lr >= 0 && lr < SR && lc >= 0 && lc < SC) return win[lr * SC + lc];
    return __ldg(g + r * X + c);
  }
};

// The W/E tile-edge blends of a2b_ord4 on the x-interface value ``val`` at
// row r (inside the plane), interface i = i0 + il, from its four taps and
// the ghost weights (w0, wp, wm) of (r, i)
template <typename T>
__device__ __forceinline__ T x_blends(const T* sh, const Plane<T> Q, T w0, T wp, T wm, T val,
                                   T qm1, T q0, T qm2, T qp1, int r, int i, int il) {
  const int Y = Q.Y;
  const T ex = sh[kEx + il];
  if (ex != T(0)) {
    const T gl = sh[kGlx + il];
    const T gr = T(1) - gl;
    const int rp = r + 1 < Y ? r + 1 : r + 1 - Y;  // the plain version's rolls
    const int rm = r - 1 >= 0 ? r - 1 : r - 1 + Y;
    const T g0 = gl * qm1 + gr * q0;
    const T gp = gl * Q(rp, i - 1) + gr * Q(rp, i);
    const T gm = gl * Q(rm, i - 1) + gr * Q(rm, i);
    const T inside = gl * q0 + gr * qm1;
    const T gt = (w0 * g0 + wp * gp) + wm * gm;
    const T qm = T(0.5) * (inside + gt);
    val = val + ex * (qm - val);
  }
  const T in_w = sh[kInw + il];
  const T in_e = sh[kIne + il];
  if (in_w != T(0) || in_e != T(0)) {
    const T os_r = ((T(0.3125) * qm1 + T(0.9375) * q0) - T(0.3125) * qp1) +
                   T(0.0625) * Q(r, i + 2);
    const T os_l = ((T(0.3125) * q0 + T(0.9375) * qm1) - T(0.3125) * qm2) +
                   T(0.0625) * Q(r, i - 3);
    const T a = in_w * (os_r - val);
    const T b = in_e * (os_l - val);
    val = (val + a) + b;
  }
  return val;
}

// y-interface value at interface row j = j0 + jl (an S/N edge row), column
// c (inside the plane), with the S/N tile-edge blends and the ghost weights
// (w0, wp, wm) of (j, c)
template <typename T>
__device__ __forceinline__ T y_iface(const T* sh, const Plane<T> Q, T w0, T wp, T wm, int j,
                                  int jl, int c) {
  const int X = Q.X;
  const T qm1 = Q(j - 1, c), q0 = Q(j, c);
  const T qm2 = Q(j - 2, c), qp1 = Q(j + 1, c);
  T val = T(0.5625) * (qm1 + q0) + T(-0.0625) * (qm2 + qp1);
  const T ey = sh[kEy + jl];
  if (ey != T(0)) {
    const T gs = sh[kGsy + jl];
    const T gn = T(1) - gs;
    const int cp = c + 1 < X ? c + 1 : c + 1 - X;
    const int cm = c - 1 >= 0 ? c - 1 : c - 1 + X;
    const T g0 = gs * qm1 + gn * q0;
    const T gp = gs * Q(j - 1, cp) + gn * Q(j, cp);
    const T gm = gs * Q(j - 1, cm) + gn * Q(j, cm);
    const T inside = gs * q0 + gn * qm1;
    const T gt = (w0 * g0 + wp * gp) + wm * gm;
    const T qm = T(0.5) * (inside + gt);
    val = val + ey * (qm - val);
  }
  const T in_s = sh[kIns + jl];
  const T in_n = sh[kInn + jl];
  if (in_s != T(0) || in_n != T(0)) {
    const T os_n = ((T(0.3125) * qm1 + T(0.9375) * q0) - T(0.3125) * qp1) +
                   T(0.0625) * Q(j + 2, c);
    const T os_s = ((T(0.3125) * q0 + T(0.9375) * qm1) - T(0.3125) * qm2) +
                   T(0.0625) * Q(j - 3, c);
    const T a = in_s * (os_n - val);
    const T b = in_n * (os_s - val);
    val = (val + a) + b;
  }
  return val;
}

// y-interface value at (j, c) of an S/N edge row that is not the tile's
// staged one (two such rows in one tile: planes of a few cells only)
template <typename T>
__device__ __noinline__ T y_iface_global(const T* yw0, const T* ywp, const T* ywm, const T* sh,
                                         const Plane<T> Q, int s, int j, int jl, int c) {
  const int w = (s * (Q.Y + 1) + j) * Q.X + c;
  return y_iface(sh, Q, yw0[w], ywp[w], ywm[w], j, jl, c);
}

// cube corner (j, i): the mean of the 3 one-sided diagonal quadratic
// extrapolations of corner table entry c; a corner beyond the last cell
// row/column reads 0, other indices wrap
template <typename T>
__device__ __forceinline__ T corner_value(const Plane<T> Q, const int* __restrict__ quad, int c,
                                       int j, int i) {
  const int Y = Q.Y, X = Q.X;
  T acc = T(0);
  for (int qd = 0; qd < 3; ++qd) {
    const int a = quad[c * 6 + 2 * qd], b = quad[c * 6 + 2 * qd + 1];
    T cell[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int aa = a >= 0 ? a + d : a - d;
      const int bb = b >= 0 ? b + d : b - d;
      cell[d] = T(0);
      if (j < Y && i < X) cell[d] = Q(((j + aa) % Y + Y) % Y, ((i + bb) % X + X) % X);
    }
    const T ext = (T(1.875) * cell[0] - T(1.25) * cell[1]) + T(0.375) * cell[2];
    acc = qd == 0 ? ext : acc + ext;
  }
  return acc / T(3);
}

// centre plane f (pk, gz, pp, delp) of interface k in device memory
template <typename T>
__device__ __forceinline__ const T* plane_ptr(const Args<T>& A, int f, int s, int k, int K,
                                              long long P) {
  const long long lev = (long long)s * (K + 1) + k;
  switch (f) {
    case 0: return A.pk + lev * P;
    case 1: return A.gz + lev * P;
    case 2: return A.pp + lev * P;
    default: return A.delp + ((long long)s * K + (k < K ? k : 0)) * P;
  }
}

// copy the raw planes of interface k (delp only below the last) into one
// slot; the window's reads clamp into the plane
template <typename T>
__device__ __forceinline__ void stage(T* slot, const Args<T>& A, int s, int k, int K, int j0,
                                      int i0, int Y, int X) {
  const long long P = (long long)Y * X;
  const T* g0 = plane_ptr(A, 0, s, k, K, P);
  const T* g1 = plane_ptr(A, 1, s, k, K, P);
  const T* g2 = plane_ptr(A, 2, s, k, K, P);
  const T* g3 = plane_ptr(A, 3, s, k, K, P);
  for (int e = threadIdx.x; e < SR * SC; e += kThreads) {
    const int lr = e / SC, lc = e - (e / SC) * SC;
    const int off = clampi(j0 - HR + lr, 0, Y - 1) * X + clampi(i0 - HR + lc, 0, X - 1);
    cp_async(slot + e, g0 + off);
    cp_async(slot + SR * SC + e, g1 + off);
    cp_async(slot + 2 * SR * SC + e, g2 + off);
    if (k < K) cp_async(slot + 3 * SR * SC + e, g3 + off);
  }
  cp_async_commit();
}

// The per-block state of a tile that meets a tile-edge line or holds a cube
// corner, in static shared memory
struct EdgeTile {
  int corner[kMaxTileCorners];  // corner table entries on the tile's corner points
  int corner_at[kMaxTileCorners];  // their (jl * BC + il)
  int n_corners;
  int xcols[QC];  // the x-interface columns (il) where a W/E blend applies
  int n_xcols;
  int xcol;  // the first W/E edge column (il), or -1: its ghost weights are staged
  int yrow;  // the first S/N edge row (jl), or -1: its y-interface values are formed
};

// the interfaces kb .. ke of one tile; EDGE: the tile meets a tile-edge
// line or holds a cube corner
template <typename T, bool EDGE>
__device__ __forceinline__ void walk(const Args<T>& A, T* sh, const EdgeTile& et, T dt,
                                     const int* __restrict__ quad, int s, int kb, int ke, int K,
                                     int Y, int X, int j0, int i0) {
  const int tid = threadIdx.x;
  const long long P = (long long)Y * X;
  const int X1 = X + 1;
  // this thread's u and v points, rows jl and jl + TY/2, and their dt / dx,
  // the same on every level
  const int jl_c = tid / TX, il_c = tid % TX;
  T dtr_u0, dtr_u1, dtr_v0, dtr_v1;
  {
    const int i = i0 + il_c, ja = j0 + jl_c, jb = ja + TY / 2;
    dtr_u0 = (ja <= Y && i < X) ? A.rdx[((long long)s * (Y + 1) + ja) * X + i] * dt : T(0);
    dtr_u1 = (jb <= Y && i < X) ? A.rdx[((long long)s * (Y + 1) + jb) * X + i] * dt : T(0);
    dtr_v0 = (ja < Y && i <= X) ? A.rdy[((long long)s * Y + ja) * X1 + i] * dt : T(0);
    dtr_v1 = (jb < Y && i <= X) ? A.rdy[((long long)s * Y + jb) * X1 + i] * dt : T(0);
  }
  // stage A's items: the x-interface values; in an edge tile, then those on
  // the columns where a W/E blend applies (one item per row, column and
  // plane), then the y-interface values of the S/N edge row (one per column
  // and plane)
  const int n_xa = QR * QC;
  const int n_xb = EDGE ? et.n_xcols * QR * NP : 0;
  const int n_a = n_xa + n_xb + (EDGE && et.yrow >= 0 ? NP * YC : 0);
  // stage B's items: the corner values; in an edge tile, then the cube
  // corners (one item per corner and plane)
  const int n_b = BR * BC + (EDGE ? et.n_corners * NP : 0);

  stage(sh + kRaw, A, s, kb, K, j0, i0, Y, X);
  for (int k = kb; k <= ke; ++k) {
    const int cur = (k - kb) & 1;
    if (k < ke) {  // the next interface's planes, into the other slot
      stage(sh + kRaw + (cur ^ 1) * NP * SR * SC, A, s, k + 1, K, j0, i0, Y, X);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int nf = k < K ? 4 : 3;  // delp has K levels
    const T* win = sh + kRaw + cur * NP * SR * SC;

    // stage A: x-interface values on rows j0-2 .. j0+TY+1 (clamped)
    for (int e = tid; e < n_a; e += kThreads) {
      if (EDGE && e >= n_xa + n_xb) {  // the S/N edge row's y-interface values
        const int f = (e - n_xa - n_xb) / YC, cl = (e - n_xa - n_xb) % YC, c = i0 - 2 + cl;
        if (f >= nf || c < 0 || c > X - 1) continue;
        const T w0 = sh[kYw + cl], wp = sh[kYw + YC + cl], wm = sh[kYw + 2 * YC + cl];
        const Plane<T> Q{win + f * SR * SC, plane_ptr(A, f, s, k, K, P), j0, i0, Y, X};
        sh[kYq + f * YC + cl] = y_iface(sh, Q, w0, wp, wm, j0 + et.yrow, et.yrow, c);
        continue;
      }
      if (EDGE && e >= n_xa) {  // a column with a W/E blend
        const int f = (e - n_xa) / (et.n_xcols * QR);
        const int m = (e - n_xa) % (et.n_xcols * QR) / QR, rl = (e - n_xa) % QR;
        if (f >= nf) continue;
        const int il = et.xcols[m], i = i0 + il;
        const T* wr = win + f * SR * SC + rl * SC + il + HR;
        const T qm1 = wr[-1], q0 = wr[0], qm2 = wr[-2], qp1 = wr[1];
        const T val = T(0.5625) * (qm1 + q0) + T(-0.0625) * (qm2 + qp1);
        const int r = clampi(j0 - 2 + rl, 0, Y - 1);
        T w0 = T(0), wp = T(0), wm = T(0);
        if (il == et.xcol) {
          w0 = sh[kXw + rl];
          wp = sh[kXw + QR + rl];
          wm = sh[kXw + 2 * QR + rl];
        } else if (sh[kEx + il] != T(0)) {
          const int w = (s * Y + r) * X1 + i;
          w0 = A.xw0[w];
          wp = A.xwp[w];
          wm = A.xwm[w];
        }
        const Plane<T> Q{win + f * SR * SC, plane_ptr(A, f, s, k, K, P), j0, i0, Y, X};
        sh[kQx + (f * QR + rl) * QC + il] =
            x_blends(sh, Q, w0, wp, wm, val, qm1, q0, qm2, qp1, r, i, il);
        continue;
      }
      const int rl = e / QC, il = e - (e / QC) * QC;
      const int i = i0 + il;
      if (i > X || (EDGE && sh[kXany + il] != T(0))) continue;
#pragma unroll
      for (int f = 0; f < NP; ++f) {
        if (f >= nf) break;
        // window row rl is plane row clamp(j0-2+rl); column il+2 is i
        const T* wr = win + f * SR * SC + rl * SC + il + HR;
        sh[kQx + (f * QR + rl) * QC + il] =
            T(0.5625) * (wr[-1] + wr[0]) + T(-0.0625) * (wr[-2] + wr[1]);
      }
    }
    __syncthreads();

    // stage B: corner values of interface k into slot cur
    T* bcur = sh + kBs + cur * NP * BR * BC;
    for (int e = tid; e < n_b; e += kThreads) {
      if (EDGE && e >= BR * BC) {  // a cube corner: its value replaces the others
        const int m = (e - BR * BC) / NP, f = (e - BR * BC) % NP;
        if (f >= nf) continue;
        const int jl = et.corner_at[m] / BC, il = et.corner_at[m] % BC;
        const Plane<T> Q{win + f * SR * SC, plane_ptr(A, f, s, k, K, P), j0, i0, Y, X};
        bcur[(f * BR + jl) * BC + il] = corner_value(Q, quad, et.corner[m], j0 + jl, i0 + il);
        continue;
      }
      const int jl = e / BC, il = e - (e / BC) * BC;
      const int j = j0 + jl, i = i0 + il;
      if (j > Y || i > X) continue;
      if (EDGE) {
        bool at_corner = false;
        for (int m = 0; m < et.n_corners; ++m) at_corner = at_corner || et.corner_at[m] == e;
        if (at_corner) continue;
      }
      const T ey = EDGE ? sh[kEy + jl] : T(0);
#pragma unroll
      for (int f = 0; f < NP; ++f) {
        if (f >= nf) break;
        const T* qxf = sh + kQx + f * QR * QC + il;
        T val = T(0.5625) * (qxf[(jl + 1) * QC] + qxf[(jl + 2) * QC]) +
                T(-0.0625) * (qxf[jl * QC] + qxf[(jl + 3) * QC]);
        if (EDGE && ey != T(0)) {
          // along the S/N edge row: 4th-order interpolation of its
          // y-interface values
          T ym1, y0, ym2, yp1;
          const int cm1 = clampi(i - 1, 0, X - 1), c0 = clampi(i, 0, X - 1);
          const int cm2 = clampi(i - 2, 0, X - 1), cp1 = clampi(i + 1, 0, X - 1);
          if (jl == et.yrow) {
            const T* yq = sh + kYq + f * YC;
            ym1 = yq[cm1 - (i0 - 2)];
            y0 = yq[c0 - (i0 - 2)];
            ym2 = yq[cm2 - (i0 - 2)];
            yp1 = yq[cp1 - (i0 - 2)];
          } else {
            const Plane<T> Q{win + f * SR * SC, plane_ptr(A, f, s, k, K, P), j0, i0, Y, X};
            ym1 = y_iface_global(A.yw0, A.ywp, A.ywm, sh, Q, s, j, jl, cm1);
            y0 = y_iface_global(A.yw0, A.ywp, A.ywm, sh, Q, s, j, jl, c0);
            ym2 = y_iface_global(A.yw0, A.ywp, A.ywm, sh, Q, s, j, jl, cm2);
            yp1 = y_iface_global(A.yw0, A.ywp, A.ywm, sh, Q, s, j, jl, cp1);
          }
          const T out_y = T(0.5625) * (ym1 + y0) + T(-0.0625) * (ym2 + yp1);
          val = val + ey * (out_y - val);
        }
        bcur[(f * BR + jl) * BC + il] = val;
      }
    }
    __syncthreads();
    if (k == kb) continue;

    // stage C: layer kk = k-1 from interfaces kk (slot cur^1) and k (slot cur)
    const int kk = k - 1;
    const T* ba = sh + kBs + (cur ^ 1) * NP * BR * BC;
    const T* bb = bcur;
#define B_(b, f, jl, il) b[((f) * BR + (jl)) * BC + (il)]
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      const int jl = jl_c + h * (TY / 2), il = il_c;
      const int j = j0 + jl, i = i0 + il;
      if (j <= Y && i < X) {  // u point (j, i): corners (j, i) and (j, i+1)
        const T p1k = B_(ba, 0, jl, il), p1kp = B_(bb, 0, jl, il);
        const T p2k = B_(ba, 0, jl, il + 1), p2kp = B_(bb, 0, jl, il + 1);
        const T g1k = B_(ba, 1, jl, il), g1kp = B_(bb, 1, jl, il);
        const T g2k = B_(ba, 1, jl, il + 1), g2kp = B_(bb, 1, jl, il + 1);
        const T q1k = B_(ba, 2, jl, il), q1kp = B_(bb, 2, jl, il);
        const T q2k = B_(ba, 2, jl, il + 1), q2kp = B_(bb, 2, jl, il + 1);
        const T dp1 = B_(ba, 3, jl, il), dp2 = B_(ba, 3, jl, il + 1);
        const T dtr = h == 0 ? dtr_u0 : dtr_u1;
        const T term_h = (g1kp - g2k) * (p2kp - p1k) + (g1k - g2kp) * (p1kp - p2k);
        const T du_h = dtr * term_h / ((p1kp - p1k) + (p2kp - p2k));
        const T term_p = (g1kp - g2k) * (q2kp - q1k) + (g1k - g2kp) * (q1kp - q2k);
        const T du_p = dtr * term_p / (dp1 + dp2);
        const long long o = (((long long)s * K + kk) * (Y + 1) + j) * X + i;
        A.u_out[o] = (A.u[o] + du_h) + du_p;
      }
      if (j < Y && i <= X) {  // v point (j, i): corners (j, i) and (j+1, i)
        const T p1k = B_(ba, 0, jl, il), p1kp = B_(bb, 0, jl, il);
        const T p2k = B_(ba, 0, jl + 1, il), p2kp = B_(bb, 0, jl + 1, il);
        const T g1k = B_(ba, 1, jl, il), g1kp = B_(bb, 1, jl, il);
        const T g2k = B_(ba, 1, jl + 1, il), g2kp = B_(bb, 1, jl + 1, il);
        const T q1k = B_(ba, 2, jl, il), q1kp = B_(bb, 2, jl, il);
        const T q2k = B_(ba, 2, jl + 1, il), q2kp = B_(bb, 2, jl + 1, il);
        const T dp1 = B_(ba, 3, jl, il), dp2 = B_(ba, 3, jl + 1, il);
        const T dtr = h == 0 ? dtr_v0 : dtr_v1;
        const T term_h = (g1kp - g2k) * (p2kp - p1k) + (g1k - g2kp) * (p1kp - p2k);
        const T dv_h = dtr * term_h / ((p1kp - p1k) + (p2kp - p2k));
        const T term_p = (g1kp - g2k) * (q2kp - q1k) + (g1k - g2kp) * (q1kp - q2k);
        const T dv_p = dtr * term_p / (dp1 + dp2);
        const long long o = (((long long)s * K + kk) * Y + j) * X1 + i;
        A.v_out[o] = (A.v[o] + dv_h) + dv_p;
      }
    }
#undef B_
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 4) pgrad_kernel(
    Args<T> A, T dt, const int* __restrict__ pos, const int* __restrict__ quad,
    const int* __restrict__ own, int n_corners, int S, int K, int Y, int X, int tiles_x,
    int k_chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ EdgeTile et;
  T* sh = reinterpret_cast<T*>(smem_raw);

  const int s = blockIdx.y;
  const int j0 = (blockIdx.x / tiles_x) * TY;
  const int i0 = (blockIdx.x % tiles_x) * TX;
  const int kb = blockIdx.z * k_chunk;
  const int ke = kb + k_chunk < K ? kb + k_chunk : K;  // interfaces kb .. ke
  const int tid = threadIdx.x;
  const int X1 = X + 1, Y1 = Y + 1;

  // the cube corners this shard owns on the tile's corner points: most
  // tiles have none
  if (tid == 0) {
    int m = 0;
    for (int c = 0; c < n_corners && m < kMaxTileCorners; ++c) {
      const int cj = pos[2 * c], ci = pos[2 * c + 1];
      if (own[c * S + s] && cj >= j0 && cj <= j0 + TY && ci >= i0 && ci <= i0 + TX) {
        et.corner[m] = c;
        et.corner_at[m] = (cj - j0) * BC + (ci - i0);
        ++m;
      }
    }
    et.n_corners = m;
  }
  // the tile's edge vectors, once per block
  bool flagged = false;
  if (tid < QC) {
    const int i = i0 + tid;
    T ex = T(0), gl = T(0), inw = T(0), ine = T(0);
    if (i <= X) {
      ex = A.ew[s * X1 + i] + A.ee[s * X1 + i];
      gl = A.glx[s * X1 + i];
      inw = A.ew[s * X1 + (i == 0 ? X : i - 1)];
      ine = A.ee[s * X1 + (i == X ? 0 : i + 1)];
    }
    sh[kEx + tid] = ex;
    sh[kGlx + tid] = gl;
    sh[kInw + tid] = inw;
    sh[kIne + tid] = ine;
    flagged = ex != T(0) || inw != T(0) || ine != T(0);
    sh[kXany + tid] = flagged ? T(1) : T(0);
  } else if (tid >= 64 && tid < 64 + BR) {
    const int jl = tid - 64, j = j0 + jl;
    T ey = T(0), gs = T(0), ins = T(0), inn = T(0);
    if (j <= Y) {
      ey = A.es[s * Y1 + j] + A.en[s * Y1 + j];
      gs = A.gsy[s * Y1 + j];
      ins = A.es[s * Y1 + (j == 0 ? Y : j - 1)];
      inn = A.en[s * Y1 + (j == Y ? 0 : j + 1)];
    }
    sh[kEy + jl] = ey;
    sh[kGsy + jl] = gs;
    sh[kIns + jl] = ins;
    sh[kInn + jl] = inn;
    flagged = ey != T(0);
  }
  const bool edge = __syncthreads_or(flagged) != 0 || et.n_corners > 0;
  if (!edge) {
    walk<T, false>(A, sh, et, dt, quad, s, kb, ke, K, Y, X, j0, i0);
    return;
  }
  // the ghost weights of the first W/E edge column and the first S/N edge
  // row, which are the same on every level
  if (tid == 0) {
    et.xcol = -1;
    et.yrow = -1;
    et.n_xcols = 0;
    for (int il = 0; il < QC; ++il)
      if (sh[kXany + il] != T(0)) et.xcols[et.n_xcols++] = il;
    for (int il = QC - 1; il >= 0; --il)
      if (sh[kEx + il] != T(0)) et.xcol = il;
    for (int jl = BR - 1; jl >= 0; --jl)
      if (sh[kEy + jl] != T(0)) et.yrow = jl;
  }
  __syncthreads();
  if (et.xcol >= 0 && tid < QR) {
    const int r = clampi(j0 - 2 + tid, 0, Y - 1);
    const int w = (s * Y + r) * X1 + i0 + et.xcol;
    sh[kXw + tid] = A.xw0[w];
    sh[kXw + QR + tid] = A.xwp[w];
    sh[kXw + 2 * QR + tid] = A.xwm[w];
  }
  if (et.yrow >= 0 && tid >= 64 && tid < 64 + YC) {
    const int cl = tid - 64, c = i0 - 2 + cl;
    if (c >= 0 && c < X) {
      const int w = (s * Y1 + j0 + et.yrow) * X + c;
      sh[kYw + cl] = A.yw0[w];
      sh[kYw + YC + cl] = A.ywp[w];
      sh[kYw + 2 * YC + cl] = A.ywm[w];
    }
  }
  __syncthreads();
  walk<T, true>(A, sh, et, dt, quad, s, kb, ke, K, Y, X, j0, i0);
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
  const size_t smem = sizeof(T) * (size_t)kValues;
  auto kern = pgrad_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  // chunks of levels: the fewest rounds of the card's block slots times the
  // interfaces a block forms (its chunk's layers and one more)
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem)) !=
      cudaSuccess)
    return (int)err;
  const long long slots = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const long long tiles = (long long)tiles_x * tiles_y * S;
  int n_chunks = 1;
  long long best = -1;
  for (int nc = 1; nc <= (K < 32 ? K : 32); ++nc) {
    const int kc = (K + nc - 1) / nc;
    const long long chunks = (K + kc - 1) / kc;
    const long long cost = ((tiles * chunks + slots - 1) / slots) * (kc + 1);
    if (best < 0 || cost < best) {
      best = cost;
      n_chunks = (int)chunks;
    }
  }
  const int k_chunk = (K + n_chunks - 1) / n_chunks;
  dim3 grid(tiles_x * tiles_y, S, n_chunks);
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      A, (T)dt, pos, quad, own, n_corners, S, K, Y, X, tiles_x, k_chunk);
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
