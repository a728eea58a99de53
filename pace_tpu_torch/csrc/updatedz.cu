// Interface heights of the nonhydrostatic acoustic substep: three kernels.
//
// heights_kernel replaces pace_tpu/ops/updatedz_pallas.py `_heights_kernel`
// (pallas_call at :90, entry heights_from_delz_pallas :67): from layer
// thickness delz (S, K, Y, X), negative, and surface geopotential phis
// (S, Y, X) it writes
//   zh[K] = phis / grav,   zh[k] = zh[K] - sum_{m>=k} delz[m]
// with the sum built first and then subtracted, sequentially from the bottom,
// as the plain version's reverse cumulative sum (ops/nonhydro.py
// heights_from_delz_plain).
// Bound on an H100: bytes (one read and one (K+1)/K write of a field, ~0.15
// GB, ~0.045 ms at 3.35 TB/s for a C192 npz=79 f32 call; two operations per
// point). Design: one thread per column (s, y, x), x fastest, so the 32 loads
// and stores of a warp at one level are one 128-byte line each.
//
// updatedz_c_kernel replaces `_updatedzc_kernel` (pallas_call at :205, entry
// updatedz_c_pallas :166): the first-order upwind advection of the interface
// heights zh_x, zh_y (S, K+1, Y, X; x and y corner folds) by the layer area
// fluxes xfx (S, K, Y, X+1), yfx (S, K, Y+1, X) of c_sw:
//   f_i[j]  = f[0] (j = 0), 0.5 (f[j-1] + f[j]) (0 < j < K), f[K-1] (j = K)
//   zx      = xfx_i > 0 ? zh_x(left cell) : zh_x(right cell)   (zy alike)
//   zh_new  = (zh_x area + dx(zx xfx_i) + dy(zy yfx_i))
//             / (area + dx(xfx_i) + dy(yfx_i))
//   ws      = (zh_new[K] - zh_x[K]) / dt2,   out[K] = zh_x[K]
// in the operation order of ops/nonhydro.py updatedz_c_plain; the
// cell-to-interface reads clamp at the plane's edge as its edge-replicating
// pads do, so the two agree on the whole plane.
// Bound: bytes (four fields read, one written, ~0.375 GB, ~0.11 ms for the
// same call; ~25 operations per point). Design: a block owns a 32 x 8 tile
// of columns; each thread walks its column's K+1 interfaces and carries the
// previous layer's four face fluxes in registers, so every layer flux is read
// once per face. Neighbouring heights come through L1 (each value is read by
// three threads of the tile); nothing is staged in shared memory.

//
// flux_height_update_kernel replaces `_flux_update_kernel` (pallas_call at
// :281, entry flux_height_update_pallas :253), the tail of updatedz_d: from
// the 2-D PPM fluxes fx (S, K+1, Y, X+1), fy (S, K+1, Y+1, X) of the heights
// and the interface-averaged area fluxes xfx_i, yfx_i of the same shapes
//   zh_new = (zh area + (fx - fx[+1]) + (fy - fy[+1]))
//            / (area + (xfx_i - xfx_i[+1]) + (yfx_i - yfx_i[+1]))
// summed left to right as ops/nonhydro.py flux_height_update_plain does,
// with one IEEE division, so the two are bit-identical.
// Bound: bytes (five fields of K+1 levels read, one written, ~0.45 GB,
// ~0.135 ms for a C192 npz=79 f32 call; 10 operations per point). Design:
// one thread per point and interface, x fastest; the east and north faces
// are the next thread's west and south faces and come through L1.

#include <cuda_runtime.h>

namespace {

constexpr int kColThreads = 128;
constexpr int kTileX = 32;
constexpr int kTileY = 8;

template <typename T>
__global__ void __launch_bounds__(kColThreads) heights_kernel(
    const T* __restrict__ delz, const T* __restrict__ phis, T grav,
    T* __restrict__ zh, int S, int K, int P) {
  const long long col = (long long)blockIdx.x * kColThreads + threadIdx.x;
  if (col >= (long long)S * P) return;
  const int s = (int)(col / P);
  const int p = (int)(col - (long long)s * P);
  const T* dz = delz + (long long)s * K * P + p;
  T* out = zh + (long long)s * (K + 1) * P + p;
  const T zs = phis[col] / grav;
  out[(long long)K * P] = zs;
  T acc = T(0);
#pragma unroll 4
  for (int k = K - 1; k >= 0; --k) {
    acc = acc + dz[(long long)k * P];
    out[(long long)k * P] = zs - acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kTileX* kTileY) updatedz_c_kernel(
    const T* __restrict__ zh_x, const T* __restrict__ zh_y,
    const T* __restrict__ xfx, const T* __restrict__ yfx,
    const T* __restrict__ area, T dt2, T* __restrict__ zh_out,
    T* __restrict__ ws, int K, int Y, int X) {
  const int x = blockIdx.x * kTileX + threadIdx.x;
  const int y = blockIdx.y * kTileY + threadIdx.y;
  const int s = blockIdx.z;
  if (x >= X || y >= Y) return;
  const long long P = (long long)Y * X;
  const long long Px = (long long)Y * (X + 1);  // an xfx plane
  const long long Py = (long long)(Y + 1) * X;  // a yfx plane
  const long long c = (long long)y * X + x;
  // clamped neighbours: the plain version's edge-replicating pads
  const long long cw = c - (x > 0 ? 1 : 0);
  const long long ce = c + (x < X - 1 ? 1 : 0);
  const long long cs = c - (y > 0 ? X : 0);
  const long long cn = c + (y < Y - 1 ? X : 0);
  const T* zx_p = zh_x + (long long)s * (K + 1) * P;
  const T* zy_p = zh_y + (long long)s * (K + 1) * P;
  T* out = zh_out + (long long)s * (K + 1) * P;
  // the four faces of the cell: west, east (xfx), south, north (yfx)
  const T* fw = xfx + (long long)s * K * Px + (long long)y * (X + 1) + x;
  const T* fs = yfx + (long long)s * K * Py + c;
  const T a = area[(long long)s * P + c];

  T pw = fw[0], pe = fw[1], ps = fs[0], pn = fs[X];  // layer j-1 (layer 0 at j = 0)
  for (int j = 0; j <= K; ++j) {
    T xw, xe, ys, yn;
    if (j == 0 || j == K) {
      xw = pw; xe = pe; ys = ps; yn = pn;
    } else {
      const long long ox = (long long)j * Px, oy = (long long)j * Py;
      const T qw = fw[ox], qe = fw[ox + 1], qs = fs[oy], qn = fs[oy + X];
      xw = T(0.5) * (pw + qw);
      xe = T(0.5) * (pe + qe);
      ys = T(0.5) * (ps + qs);
      yn = T(0.5) * (pn + qn);
      pw = qw; pe = qe; ps = qs; pn = qn;
    }
    const long long o = (long long)j * P;
    const T zc = zx_p[o + c];
    const T yc = zy_p[o + c];
    const T zw = xw > T(0) ? zx_p[o + cw] : zc;
    const T ze = xe > T(0) ? zc : zx_p[o + ce];
    const T zs = ys > T(0) ? zy_p[o + cs] : yc;
    const T zn = yn > T(0) ? yc : zy_p[o + cn];
    const T ra = (a + (xw - xe)) + (ys - yn);
    const T zh_new = ((zc * a + (zw * xw - ze * xe)) + (zs * ys - zn * yn)) / ra;
    if (j == K) {
      // the bottom interface is pinned to the surface; its advected value
      // only feeds the terrain-following ws
      out[o + c] = zc;
      ws[(long long)s * P + c] = (zh_new - zc) / dt2;
    } else {
      out[o + c] = zh_new;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kTileX* kTileY) flux_height_update_kernel(
    const T* __restrict__ zh, const T* __restrict__ fx, const T* __restrict__ fy,
    const T* __restrict__ xfx, const T* __restrict__ yfx,
    const T* __restrict__ area, T* __restrict__ out, int K1, int Y, int X) {
  const int x = blockIdx.x * kTileX + threadIdx.x;
  const int y = blockIdx.y * kTileY + threadIdx.y;
  if (x >= X || y >= Y) return;
  const int s = blockIdx.z / K1;
  const long long lev = blockIdx.z;  // s * K1 + interface
  const long long c = lev * Y * X + (long long)y * X + x;
  const long long w = lev * Y * (X + 1) + (long long)y * (X + 1) + x;  // west face
  const long long so = lev * (Y + 1) * X + (long long)y * X + x;       // south face
  const T a = area[(long long)s * Y * X + (long long)y * X + x];
  const T ra = (a + (xfx[w] - xfx[w + 1])) + (yfx[so] - yfx[so + X]);
  out[c] = ((zh[c] * a + (fx[w] - fx[w + 1])) + (fy[so] - fy[so + X])) / ra;
}

template <typename T>
int launch_flux_height_update(const void* zh, const void* fx, const void* fy,
                              const void* xfx, const void* yfx,
                              const void* area, void* out, int S, int K1, int Y,
                              int X, void* stream) {
  const dim3 block(kTileX, kTileY);
  const dim3 grid((X + kTileX - 1) / kTileX, (Y + kTileY - 1) / kTileY, S * K1);
  flux_height_update_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)zh, (const T*)fx, (const T*)fy, (const T*)xfx, (const T*)yfx,
      (const T*)area, (T*)out, K1, Y, X);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_heights(const void* delz, const void* phis, double grav, void* zh,
                   int S, int K, int P, void* stream) {
  const long long cols = (long long)S * P;
  const unsigned blocks = (unsigned)((cols + kColThreads - 1) / kColThreads);
  heights_kernel<T><<<blocks, kColThreads, 0, (cudaStream_t)stream>>>(
      (const T*)delz, (const T*)phis, (T)grav, (T*)zh, S, K, P);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_updatedz_c(const void* zh_x, const void* zh_y, const void* xfx,
                      const void* yfx, const void* area, double dt2,
                      void* zh_out, void* ws, int S, int K, int Y, int X,
                      void* stream) {
  const dim3 block(kTileX, kTileY);
  const dim3 grid((X + kTileX - 1) / kTileX, (Y + kTileY - 1) / kTileY, S);
  updatedz_c_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)zh_x, (const T*)zh_y, (const T*)xfx, (const T*)yfx,
      (const T*)area, (T)dt2, (T*)zh_out, (T*)ws, K, Y, X);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pace_heights_f32(const void* delz, const void* phis, double grav,
                                void* zh, int S, int K, int P, void* stream) {
  return launch_heights<float>(delz, phis, grav, zh, S, K, P, stream);
}

extern "C" int pace_heights_f64(const void* delz, const void* phis, double grav,
                                void* zh, int S, int K, int P, void* stream) {
  return launch_heights<double>(delz, phis, grav, zh, S, K, P, stream);
}

extern "C" int pace_updatedz_c_f32(const void* zh_x, const void* zh_y,
                                   const void* xfx, const void* yfx,
                                   const void* area, double dt2, void* zh_out,
                                   void* ws, int S, int K, int Y, int X,
                                   void* stream) {
  return launch_updatedz_c<float>(zh_x, zh_y, xfx, yfx, area, dt2, zh_out, ws, S,
                                  K, Y, X, stream);
}

extern "C" int pace_updatedz_c_f64(const void* zh_x, const void* zh_y,
                                   const void* xfx, const void* yfx,
                                   const void* area, double dt2, void* zh_out,
                                   void* ws, int S, int K, int Y, int X,
                                   void* stream) {
  return launch_updatedz_c<double>(zh_x, zh_y, xfx, yfx, area, dt2, zh_out, ws,
                                   S, K, Y, X, stream);
}

// zh, out (S, K1, Y, X); fx, xfx (S, K1, Y, X+1); fy, yfx (S, K1, Y+1, X);
// area (S, Y, X); K1 = K + 1 interfaces.
extern "C" int pace_flux_height_update_f32(const void* zh, const void* fx,
                                           const void* fy, const void* xfx,
                                           const void* yfx, const void* area,
                                           void* out, int S, int K1, int Y,
                                           int X, void* stream) {
  return launch_flux_height_update<float>(zh, fx, fy, xfx, yfx, area, out, S, K1,
                                          Y, X, stream);
}

extern "C" int pace_flux_height_update_f64(const void* zh, const void* fx,
                                           const void* fy, const void* xfx,
                                           const void* yfx, const void* area,
                                           void* out, int S, int K1, int Y,
                                           int X, void* stream) {
  return launch_flux_height_update<double>(zh, fx, fy, xfx, yfx, area, out, S,
                                           K1, Y, X, stream);
}
