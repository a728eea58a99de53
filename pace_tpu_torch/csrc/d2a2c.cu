// D-grid -> A-grid -> C-grid wind staggering transforms, fused in one kernel.
//
// Replaces pace_tpu/ops/d2a2c_pallas.py `_kernel` (pallas_call at :177,
// entry d2a2c_vect_pallas :194). From the D-grid covariant winds u (Y+1, X)
// and v (Y, X+1) it produces ua, va (cell centers), uc, ut (x-interfaces)
// and vc, vt (y-interfaces): 4th-order D->A averages, the Cartesian
// 3-vector at centers (least-squares solve in the tile-edge band), its
// 4th-order interpolation to the interfaces projected on the C-grid bases,
// and the contravariant C winds. Arithmetic follows
// pace_tpu_torch/ops/d2a2c.py (d2a2c_plain) op for op; built with
// -fmad=false it rounds like the plain PyTorch version.
//
// Layout: cell-aligned. Interface i of an x-interface array (Y, X+1) sits
// at cell slot i. The D->A stencil wraps around the interface axis exactly
// like the plain version's rolls, so the Cartesian vector, ua and va equal
// the plain version on the whole plane, and uc, vc on all but their outer
// two rings (c_sw reads ring 2 of uc, vc next to a tile's north and east
// edge). Cells beyond the plane, which only those outer rings and the outer
// three rings of ut, vt depend on, are read clamped to its edge; the plain
// version's edge pads leave other values there, and no consumer reads
// them. The last interface column of uc/ut and row of vc/vt is written as
// zero, as the TPU kernel does.
//
// Bound on an H100: bytes. About 120 flops per cell and level against 8
// field values moved (2 read, 6 written): ~0.6 GB and ~0.18 ms at 3.35 TB/s
// for a C192 npz=79 f32 call, ~0.03 ms of arithmetic at 67 TFLOP/s. The 40
// grid constants a cell needs (34 planes per shard) do not depend on the
// level and would outweigh the fields if they were fetched per level.
// Design: one block per (16x32 tile, chunk of levels, shard). A thread owns
// one point of each of the three stages (Cartesian vector on tile+2, uc/vc
// on tile+1, ut/vt on the tile), loads that point's constants into
// registers once, and walks the chunk's levels; per level the block stages
// u and v with their margin in shared memory and keeps the Cartesian vector
// and the C winds there, so device memory sees one read of u, v (plus the
// margin overlap) and one write of the six outputs. The next level's u, v
// are fetched into registers while the current level is computed: with one
// block per SM nothing else hides the load latency.

#include <cuda_runtime.h>

namespace {

constexpr int TY = 16;
constexpr int TX = 32;
constexpr int VY = TY + 4;  // Cartesian vector: rows j0-2 .. j0+TY+1
constexpr int VX = TX + 4;
constexpr int UY = TY + 7;  // staged u: rows j0-3 .. j0+TY+3, cols as VX
constexpr int WX = TX + 7;  // staged v: cols i0-3 .. i0+TX+3, rows as VY
constexpr int CY = TY + 1;  // uc: rows j0-1 .. j0+TY-1, cols i0 .. i0+TX
constexpr int CX = TX + 1;  // vc: rows j0 .. j0+TY, cols i0-1 .. i0+TX-1
constexpr int kThreads = 736;  // >= VY * VX
constexpr int kLevels = 16;    // levels walked by one block
static_assert(UY * VX <= 2 * kThreads && VY * WX <= 2 * kThreads,
              "a thread stages at most two points of u and of v");

__device__ __forceinline__ int clampi(int a, int lo, int hi) {
  return a < lo ? lo : (a > hi ? hi : a);
}
__device__ __forceinline__ int wrapi(int a, int n) { return ((a % n) + n) % n; }

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) d2a2c_kernel(
    const T* __restrict__ u, const T* __restrict__ v,
    const T* __restrict__ rsin2, const T* __restrict__ cosa_s,
    const T* __restrict__ band, const T* __restrict__ cosa_u,
    const T* __restrict__ rsin_u2, const T* __restrict__ cosa_v,
    const T* __restrict__ rsin_v2, const T* __restrict__ ec1,
    const T* __restrict__ ec2, const T* __restrict__ ew1,
    const T* __restrict__ ew2, const T* __restrict__ es1,
    const T* __restrict__ es2, const T* __restrict__ minv,
    T* __restrict__ ua, T* __restrict__ va, T* __restrict__ uc,
    T* __restrict__ vc, T* __restrict__ ut, T* __restrict__ vt, int K, int Y,
    int X) {
  __shared__ T s_u[UY * VX];
  __shared__ T s_v[VY * WX];
  __shared__ T s_q[3 * VY * VX];  // Cartesian wind vector
  __shared__ T s_uc[CY * CX];
  __shared__ T s_vc[CY * CX];

  const T A1 = T(9.0 / 16.0);
  const T A2 = T(-1.0 / 16.0);
  const int X1 = X + 1;
  const int Y1 = Y + 1;
  const int tiles_x = (X + TX - 1) / TX;
  const int j0 = (blockIdx.x / tiles_x) * TY;
  const int i0 = (blockIdx.x % tiles_x) * TX;
  const int s = blockIdx.z;
  const int k_begin = blockIdx.y * kLevels;
  const int k_end = k_begin + kLevels < K ? k_begin + kLevels : K;
  const int t = threadIdx.x;

  const long long pc = (long long)s * Y * X;    // cell planes
  const long long px = (long long)s * Y * X1;   // x-interface planes
  const long long py = (long long)s * Y1 * X;   // y-interface planes

  // --- stage 1 point: Cartesian vector at cell (r1, c1) of tile+2
  const bool on1 = t < VY * VX;
  const int a1 = on1 ? t / VX : 0;
  const int b1 = on1 ? t - a1 * VX : 0;
  const int r1 = j0 - 2 + a1;
  const int c1 = i0 - 2 + b1;
  const bool write1 = on1 && r1 >= j0 && r1 < j0 + TY && c1 >= i0 &&
                      c1 < i0 + TX && r1 < Y && c1 < X;
  T k_rsin2 = T(0), k_cosa_s = T(0);
  bool k_band = false;
  T k_ec1[3], k_ec2[3], k_es1a[3], k_es1b[3], k_ew2a[3], k_ew2b[3], k_minv[9];
  if (on1) {
    const int rc = clampi(r1, 0, Y - 1);
    const int cc = clampi(c1, 0, X - 1);
    const int m = rc * X + cc;
    k_rsin2 = rsin2[pc + m];
    k_cosa_s = cosa_s[pc + m];
    k_band = band[pc + m] > T(0.5);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      k_ec1[c] = ec1[(3 * pc) + (long long)c * Y * X + m];
      k_ec2[c] = ec2[(3 * pc) + (long long)c * Y * X + m];
      k_es1a[c] = es1[(3 * py) + (long long)c * Y1 * X + rc * X + cc];
      k_es1b[c] = es1[(3 * py) + (long long)c * Y1 * X + (rc + 1) * X + cc];
      k_ew2a[c] = ew2[(3 * px) + (long long)c * Y * X1 + rc * X1 + cc];
      k_ew2b[c] = ew2[(3 * px) + (long long)c * Y * X1 + rc * X1 + cc + 1];
    }
#pragma unroll
    for (int c = 0; c < 9; ++c) k_minv[c] = minv[(9 * pc) + (long long)c * Y * X + m];
  }

  // --- stage 2 point: uc at (j0-1+a2, i0+b2), vc at (j0+a2, i0-1+b2)
  const bool on2 = t < CY * CX;
  const int a2 = on2 ? t / CX : 0;
  const int b2 = on2 ? t - a2 * CX : 0;
  T k_ew1[3], k_es2[3];
  if (on2) {
    const int ru = clampi(j0 - 1 + a2, 0, Y - 1);
    const int cu = clampi(i0 + b2, 0, X);
    const int rv = clampi(j0 + a2, 0, Y);
    const int cv = clampi(i0 - 1 + b2, 0, X - 1);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      k_ew1[c] = ew1[(3 * px) + (long long)c * Y * X1 + ru * X1 + cu];
      k_es2[c] = es2[(3 * py) + (long long)c * Y1 * X + rv * X + cv];
    }
  }

  // --- stage 3 point: ut, vt at cell slot (j3, i3) of the tile
  const int a3 = t / TX;
  const int b3 = t - a3 * TX;
  const int j3 = j0 + a3;
  const int i3 = i0 + b3;
  const bool on3 = t < TY * TX && j3 < Y && i3 < X;
  T k_cosa_u = T(0), k_rsin_u2 = T(0), k_cosa_v = T(0), k_rsin_v2 = T(0);
  if (on3) {
    k_cosa_u = cosa_u[px + j3 * X1 + i3];
    k_rsin_u2 = rsin_u2[px + j3 * X1 + i3];
    k_cosa_v = cosa_v[py + j3 * X + i3];
    k_rsin_v2 = rsin_v2[py + j3 * X + i3];
  }

  // Staging offsets of this thread (each thread stages at most two points
  // of u and two of v): wrapped along the interface axis (the plain
  // version's rolls), clamped along the other.
  int off_u[2], off_v[2];
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int iu = t + n * kThreads;
    const int au = iu / VX;
    off_u[n] = iu < UY * VX
                   ? wrapi(j0 - 3 + au, Y1) * X + clampi(i0 - 2 + iu - au * VX, 0, X - 1)
                   : -1;
    const int iv = t + n * kThreads;
    const int av = iv / WX;
    off_v[n] = iv < VY * WX
                   ? clampi(j0 - 2 + av, 0, Y - 1) * X1 + wrapi(i0 - 3 + iv - av * WX, X1)
                   : -1;
  }
  // the next level's u, v wait in registers while this level is computed
  T pre_u[2], pre_v[2];
  auto prefetch = [&](int k) {
    const long long lev = (long long)s * K + k;
    const T* u_p = u + lev * Y1 * X;
    const T* v_p = v + lev * Y * X1;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      pre_u[n] = off_u[n] >= 0 ? u_p[off_u[n]] : T(0);
      pre_v[n] = off_v[n] >= 0 ? v_p[off_v[n]] : T(0);
    }
  };
  if (k_begin < k_end) prefetch(k_begin);

  for (int k = k_begin; k < k_end; ++k) {
    const long long lev = (long long)s * K + k;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      if (off_u[n] >= 0) s_u[t + n * kThreads] = pre_u[n];
      if (off_v[n] >= 0) s_v[t + n * kThreads] = pre_v[n];
    }
    __syncthreads();
    if (k + 1 < k_end) prefetch(k + 1);

    // stage 1: Cartesian wind at centers; ua, va on the tile
    if (on1) {
      const T u_jm1 = s_u[a1 * VX + b1];
      const T u_j = s_u[(a1 + 1) * VX + b1];
      const T u_jp1 = s_u[(a1 + 2) * VX + b1];
      const T u_jp2 = s_u[(a1 + 3) * VX + b1];
      const T v_im1 = s_v[a1 * WX + b1];
      const T v_i = s_v[a1 * WX + b1 + 1];
      const T v_ip1 = s_v[a1 * WX + b1 + 2];
      const T v_ip2 = s_v[a1 * WX + b1 + 3];
      const T utmp = A1 * (u_j + u_jp1) + A2 * (u_jm1 + u_jp2);
      const T vtmp = A1 * (v_i + v_ip1) + A2 * (v_im1 + v_ip2);
      const T ua4 = (utmp - vtmp * k_cosa_s) * k_rsin2;
      const T va4 = (vtmp - utmp * k_cosa_s) * k_rsin2;
      T q[3];
      if (k_band) {
        T bb[3];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          bb[c] = ((u_j * k_es1a[c] + u_jp1 * k_es1b[c]) + v_i * k_ew2a[c]) +
                  v_ip1 * k_ew2b[c];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          q[c] = (k_minv[3 * c] * bb[0] + k_minv[3 * c + 1] * bb[1]) +
                 k_minv[3 * c + 2] * bb[2];
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) q[c] = ua4 * k_ec1[c] + va4 * k_ec2[c];
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) s_q[c * VY * VX + t] = q[c];
      if (write1) {
        const T u_cov = (q[0] * k_ec1[0] + q[1] * k_ec1[1]) + q[2] * k_ec1[2];
        const T v_cov = (q[0] * k_ec2[0] + q[1] * k_ec2[1]) + q[2] * k_ec2[2];
        ua[lev * Y * X + r1 * X + c1] = (u_cov - v_cov * k_cosa_s) * k_rsin2;
        va[lev * Y * X + r1 * X + c1] = (v_cov - u_cov * k_cosa_s) * k_rsin2;
      }
    }
    __syncthreads();

    // stage 2: centers -> interfaces on the Cartesian vector, projected
    if (on2) {
      T acc_u = T(0), acc_v = T(0);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const T* row = s_q + c * VY * VX + (a2 + 1) * VX + b2;
        const T qx = A1 * (row[1] + row[2]) + A2 * (row[0] + row[3]);
        const T* col = s_q + c * VY * VX + a2 * VX + b2 + 1;
        const T qy = A1 * (col[VX] + col[2 * VX]) + A2 * (col[0] + col[3 * VX]);
        const T tu = qx * k_ew1[c];
        const T tv = qy * k_es2[c];
        acc_u = c == 0 ? tu : acc_u + tu;
        acc_v = c == 0 ? tv : acc_v + tv;
      }
      s_uc[t] = acc_u;
      s_vc[t] = acc_v;
    }
    __syncthreads();

    // stage 3: contravariant C winds; write uc, vc, ut, vt
    if (on3) {
      const T uc00 = s_uc[a3 * CX + b3];            // uc[j-1, i]
      const T uc01 = s_uc[a3 * CX + b3 + 1];        // uc[j-1, i+1]
      const T uc10 = s_uc[(a3 + 1) * CX + b3];      // uc[j, i]
      const T uc11 = s_uc[(a3 + 1) * CX + b3 + 1];  // uc[j, i+1]
      const T vc00 = s_vc[a3 * CX + b3];            // vc[j, i-1]
      const T vc01 = s_vc[a3 * CX + b3 + 1];        // vc[j, i]
      const T vc10 = s_vc[(a3 + 1) * CX + b3];      // vc[j+1, i-1]
      const T vc11 = s_vc[(a3 + 1) * CX + b3 + 1];  // vc[j+1, i]
      const T vc4 = T(0.25) * ((vc00 + vc10) + (vc01 + vc11));
      const T uc4 = T(0.25) * ((uc00 + uc01) + (uc10 + uc11));
      const long long ox = lev * Y * X1 + j3 * X1 + i3;
      const long long oy = lev * Y1 * X + j3 * X + i3;
      uc[ox] = uc10;
      ut[ox] = (uc10 - k_cosa_u * vc4) * k_rsin_u2;
      vc[oy] = vc01;
      vt[oy] = (vc01 - k_cosa_v * uc4) * k_rsin_v2;
      if (i3 == X - 1) {
        uc[ox + 1] = T(0);
        ut[ox + 1] = T(0);
      }
      if (j3 == Y - 1) {
        vc[oy + X] = T(0);
        vt[oy + X] = T(0);
      }
    }
    // no barrier needed here: the next level's staging writes s_u/s_v only,
    // last read in stage 1, and two barriers separate any reuse of s_q,
    // s_uc and s_vc from their last readers
  }
}

template <typename T>
int launch(const void* const* p, int S, int K, int Y, int X, void* stream) {
  const int tiles = ((Y + TY - 1) / TY) * ((X + TX - 1) / TX);
  dim3 grid(tiles, (K + kLevels - 1) / kLevels, S);
  d2a2c_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3],
      (const T*)p[4], (const T*)p[5], (const T*)p[6], (const T*)p[7],
      (const T*)p[8], (const T*)p[9], (const T*)p[10], (const T*)p[11],
      (const T*)p[12], (const T*)p[13], (const T*)p[14], (const T*)p[15],
      (T*)p[16], (T*)p[17], (T*)p[18], (T*)p[19], (T*)p[20], (T*)p[21], K, Y, X);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: u, v, rsin2, cosa_s, band_c, cosa_u, rsin_u2, cosa_v, rsin_v2, ec1,
// ec2, ew1, ew2, es1, es2, minv, then the outputs ua, va, uc, vc, ut, vt
// (22 device pointers in a host array).
extern "C" int pace_d2a2c_f32(const void* const* ptrs, int S, int K, int Y,
                              int X, void* stream) {
  return launch<float>(ptrs, S, K, Y, X, stream);
}

extern "C" int pace_d2a2c_f64(const void* const* ptrs, int S, int K, int Y,
                              int X, void* stream) {
  return launch<double>(ptrs, S, K, Y, X, stream);
}
