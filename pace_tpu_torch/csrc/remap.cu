// Lagrangian -> Eulerian vertical remap, one thread per column.
//
// Replaces pace_tpu/ops/remap_pallas.py `_remap_kernel` (pallas_call at
// :222). From layer means q (L, K, P) on source interfaces pe1 and target
// interfaces pe2 (read through l / rep, so a tracer block shares one pair of
// pressure columns that is never broadcast in memory) it produces the
// target layer means (L, K2-1, P) of ops/remapping.py remap_field:
//   1. the PPM reconstruction of the kord family (vertical_reconstruction):
//      interface values (CW84-limited for |kord| <= 8, the clamped
//      unlimited cubic above), the one-sided column ends, then the full
//      monotone constraint (|kord| <= 6), overshoot corrections with the
//      edge cells constrained (7), or the selective constraint of the noise
//      mask (8; 9; 10 and above with the loose trigger), and the
//      positive-definite constraint for kord < 0;
//   2. the running integral Q1 of q dp1 at the cell tops, summed in k;
//   3. for each target interface, the source cell that holds it, counted
//      among the D_OFFSET = 5 cells on either side of the target's own index
//      (this agrees with the plain version's count over the whole column
//      wherever pe1 increases down the column), and the integral Q1 + dp1 F(t)
//      of that cell's parabola;
//   4. the differences of the integrals over the target thicknesses.
// Operation order, divisions included, is the plain version's, so the two
// agree to the rounding of the cumulative sum (sequential on the card).
// The rolls along k of the plain version wrap at the column ends; every
// value they wrap into is replaced by the one-sided ends or the edge
// constraint, so indices here wrap the same way without consequence.
//
// Bound on an H100: bytes. q and the two pressure columns in, the result out:
// about 318 planes, 0.30 GB for one C192 npz=79 f32 field (0.09 ms at
// 3.35 TB/s); a nine-tracer block reads the columns once per tracer in this
// design, but the bound counts them once: about 1582 planes, 1.49 GB, 0.44 ms.
// Design: thread per column (x fastest, so a warp's loads at one level are
// one line); the column's q (then Q1), pe1, a_l, d_a and a6 live in shared
// memory as [level][thread], 5K+1 values a thread (101 KB in f32 at K=79
// with 64 threads); the kernel is templated on the kord class and its sign.

#include <cuda_runtime.h>

namespace {

constexpr int D_OFFSET = 5;

template <typename T>
__device__ __forceinline__ T vmin(T a, T b) { return a < b ? a : b; }
template <typename T>
__device__ __forceinline__ T vmax(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T vabs(T a) { return a < T(0) ? -a : a; }

// torch.clamp(x, lo, hi): max with lo, then min with hi
template <typename T>
__device__ __forceinline__ T vclamp(T x, T lo, T hi) { return vmin(vmax(x, lo), hi); }

// _monotone_limit of ops/ppm.py
template <typename T>
__device__ __forceinline__ void monotone(T& bl, T& br) {
  const T da = br - bl;
  const T a6 = T(-3) * (bl + br);
  const bool extremum = bl * br >= T(0);
  const bool over_r = da * a6 > da * da;
  const bool over_l = -(da * da) > da * a6;
  const T bl2 = over_r ? T(-2) * br : bl;
  const T br2 = (over_l && !over_r) ? T(-2) * bl : br;
  bl = extremum ? T(0) : bl2;
  br = extremum ? T(0) : br2;
}

// _overshoot_limit of ops/remapping.py
template <typename T>
__device__ __forceinline__ void overshoot(T& bl, T& br) {
  const T da = br - bl;
  const T a6 = T(-3) * (bl + br);
  const bool over_r = da * a6 > da * da;
  const bool over_l = -(da * da) > da * a6;
  const T bl2 = over_r ? T(-2) * br : bl;
  const T br2 = (over_l && !over_r) ? T(-2) * bl : br;
  bl = bl2;
  br = br2;
}

template <typename T>
__device__ __forceinline__ T vertex_min(T bl, T br, T al) {
  const T da = br - bl;
  const T a6 = T(-3) * (bl + br);
  const bool has_vertex = vabs(da) < vabs(a6);
  const T safe_a6 = a6 == T(0) ? T(1e-30) : a6;
  const T s = da + a6;
  const T pv = al + (s * s) / (T(4) * safe_a6);
  return has_vertex ? pv : al;
}

// _positive_limit of ops/ppm.py
template <typename T>
__device__ __forceinline__ void positive(T q, T& bl, T& br) {
  const T aL = q + bl, aR = q + br;
  const T p_min = vmin(vmin(aL, aR), vertex_min(bl, br, aL));
  if (!(p_min < T(0))) return;
  T bl1 = vmax(bl, -q), br1 = vmax(br, -q);
  if (vertex_min(bl1, br1, q + bl1) < T(0)) {
    bl1 = T(0);
    br1 = T(0);
  }
  bl = bl1;
  br = br1;
}

template <typename T, int CLS, bool NEG>
__global__ void __launch_bounds__(64) remap_kernel(
    const T* __restrict__ q, const T* __restrict__ pe1, const T* __restrict__ pe2,
    T* __restrict__ out, long long L, int rep1, int rep2, int K, int K2, int P) {
  extern __shared__ unsigned char smem_raw[];
  const int NT = blockDim.x;
  const int t = threadIdx.x;
  T* sq = reinterpret_cast<T*>(smem_raw);  // q, then Q1 at the cell tops
  T* spe = sq + K * NT;                    // pe1, K+1 levels
  T* sal = spe + (K + 1) * NT;             // interface values, then a_l
  T* sa = sal + K * NT;                    // slopes, then bl, then d_a
  T* sb = sa + K * NT;                     // br, then a6
  const long long col = (long long)blockIdx.x * NT + t;
  if (col >= L * P) return;
  const long long l = col / P;
  const int p = (int)(col - l * P);
  const T* qc = q + l * K * P + p;
  const T* p1 = pe1 + (l / rep1) * (long long)(K + 1) * P + p;
  const T* p2 = pe2 + (l / rep2) * (long long)K2 * P + p;
  T* oc = out + l * (long long)(K2 - 1) * P + p;
#define SH(a, k) a[(k) * NT + t]
  // k wrapped into the column, as the plain version's rolls wrap; every
  // index here is within one column length of it, so no division is needed
  // (columns of fewer than 3 cells take the modulo)
  auto w = [K](int k) {
    return K >= 3 ? (k < 0 ? k + K : (k >= K ? k - K : k)) : ((k % K) + K) % K;
  };

  for (int k = 0; k < K; ++k) SH(sq, k) = qc[(long long)k * P];
  for (int k = 0; k <= K; ++k) SH(spe, k) = p1[(long long)k * P];

  // interface values al[k] (interface above cell k)
  if (CLS <= 8) {
    for (int k = 0; k < K; ++k) {  // limited slopes (_limited_slope)
      const T qp = SH(sq, w(k + 1)), qm = SH(sq, w(k - 1)), q0 = SH(sq, k);
      const T dm = T(0.5) * (qp - qm);
      const T dq_r = qp - q0, dq_l = q0 - qm;
      const T lim = vmin(vabs(dm), T(2) * vmin(vabs(dq_r), vabs(dq_l)));
      const T sgn = dm > T(0) ? T(1) : (dm < T(0) ? T(-1) : T(0));
      SH(sa, k) = dq_r * dq_l > T(0) ? sgn * lim : T(0);
    }
    for (int k = 0; k < K; ++k) {
      const int km = w(k - 1);
      SH(sal, k) = T(0.5) * (SH(sq, km) + SH(sq, k)) + (SH(sa, km) - SH(sa, k)) / T(6);
    }
  } else {
    for (int k = 0; k < K; ++k) {
      const T q0 = SH(sq, k), qm1 = SH(sq, w(k - 1)), qm2 = SH(sq, w(k - 2));
      const T qp1 = SH(sq, w(k + 1));
      const T al = T(7.0 / 12.0) * (qm1 + q0) - T(1.0 / 12.0) * (qm2 + qp1);
      const T lo = vmin(vmin(q0, qm1), vmin(qm2, qp1));
      const T hi = vmax(vmax(q0, qm1), vmax(qm2, qp1));
      const T r = hi - lo;
      SH(sal, k) = vclamp(al, lo - r, hi + r);
    }
  }
  for (int k = 0; k < K; ++k) {
    const T q0 = SH(sq, k);
    SH(sa, k) = SH(sal, k) - q0;        // bl
    SH(sb, k) = SH(sal, w(k + 1)) - q0;  // br
  }
  // one-sided column ends
  if (K < 3) {
    for (int k = 0; k < K; ++k) {
      SH(sa, k) = T(0);
      SH(sb, k) = T(0);
    }
  } else {
    const T q0 = SH(sq, 0), q1 = SH(sq, 1), q2 = SH(sq, 2);
    const T qm1 = SH(sq, K - 1), qm2 = SH(sq, K - 2), qm3 = SH(sq, K - 3);
    T al0 = ((T(11) * q0 - T(7) * q1) + T(2) * q2) / T(6);
    T al1 = ((T(2) * q0 + T(5) * q1) - q2) / T(6);
    T alK = ((T(11) * qm1 - T(7) * qm2) + T(2) * qm3) / T(6);
    T alK1 = ((T(2) * qm1 + T(5) * qm2) - qm3) / T(6);
    if (CLS <= 8) {
      const T lo01 = vmin(q0, q1), hi01 = vmax(q0, q1);
      const T loK = vmin(qm1, qm2), hiK = vmax(qm1, qm2);
      al0 = vclamp(al0, lo01, hi01);
      al1 = vclamp(al1, lo01, hi01);
      alK = vclamp(alK, loK, hiK);
      alK1 = vclamp(alK1, loK, hiK);
    }
    SH(sa, 0) = al0 - q0;
    SH(sa, 1) = al1 - q1;
    SH(sa, K - 1) = alK1 - qm1;
    SH(sb, 0) = al1 - q0;
    SH(sb, K - 2) = alK1 - qm2;
    SH(sb, K - 1) = alK - qm1;
  }
  // the constraint of the kord class, then the coefficients
  for (int k = 0; k < K; ++k) {
    const T q0 = SH(sq, k);
    T bl = SH(sa, k), br = SH(sb, k);
    if (CLS <= 6) {
      monotone(bl, br);
    } else {
      bool sel;
      if (CLS == 7) {
        sel = k <= 1 || k >= K - 2;
      } else {  // noise mask (_noise_mask)
        T d2[3];
        bool ext[3];
        for (int d = 0; d < 3; ++d) {
          const int m = w(k - 1 + d);
          const T qc0 = SH(sq, m);
          const T dqm = qc0 - SH(sq, w(m - 1));
          const T dqp = SH(sq, w(m + 1)) - qc0;
          ext[d] = dqm * dqp <= T(0);
          d2[d] = dqp - dqm;
        }
        const bool smooth = (d2[1] * d2[0] > T(0)) && (d2[1] * d2[2] > T(0));
        sel = ext[1] && !smooth;
        if (CLS >= 10) sel = sel && (ext[0] || ext[2]);
        sel = sel || k <= 1 || k >= K - 2;
      }
      T blm = bl, brm = br, blo = bl, bro = br;
      monotone(blm, brm);
      overshoot(blo, bro);
      bl = sel ? blm : blo;
      br = sel ? brm : bro;
    }
    if (NEG) positive(q0, bl, br);
    SH(sal, k) = q0 + bl;
    SH(sa, k) = br - bl;
    SH(sb, k) = T(-3) * (bl + br);
  }
  // running integral at the cell tops
  T acc = T(0);
  for (int k = 0; k < K; ++k) {
    const T qdp = SH(sq, k) * (SH(spe, k + 1) - SH(spe, k));
    SH(sq, k) = acc;
    acc = k == 0 ? qdp : acc + qdp;
  }
  // integrals at the target interfaces and their differences
  T q_prev = T(0), p_prev = T(0);
  for (int j = 0; j < K2; ++j) {
    const T pj = p2[(long long)j * P];
    const int base = j - 1 < 0 ? 0 : (j - 1 > K - 1 ? K - 1 : j - 1);
    int m_loc = 0;
    for (int o = -D_OFFSET; o <= D_OFFSET; ++o) {
      const int kk = base + o;
      if (kk < 0 || kk > K - 1) continue;
      const int cmp = SH(spe, kk + 1) <= pj ? 1 : 0;
      m_loc += o < 0 ? cmp - 1 : cmp;
    }
    const int off = m_loc < -D_OFFSET ? -D_OFFSET : (m_loc > D_OFFSET ? D_OFFSET : m_loc);
    int idx = j - 1 + off;
    idx = idx < 0 ? 0 : (idx > K - 1 ? K - 1 : idx);
    const T pe1_m = SH(spe, idx);
    const T dp1_m = SH(spe, idx + 1) - pe1_m;
    const T tt = vclamp((pj - pe1_m) / dp1_m, T(0), T(1));
    const T t2 = tt * tt;
    const T t3 = t2 * tt;
    const T f = (SH(sal, idx) * tt + (T(0.5) * SH(sa, idx)) * t2) +
                SH(sb, idx) * (T(0.5) * t2 - t3 / T(3));
    const T q_int = SH(sq, idx) + dp1_m * f;
    if (j > 0) oc[(long long)(j - 1) * P] = (q_int - q_prev) / (pj - p_prev);
    q_prev = q_int;
    p_prev = pj;
  }
#undef SH
}

template <typename T, int CLS, bool NEG>
int launch_one(const void* q, const void* pe1, const void* pe2, void* out, long long L,
               int rep1, int rep2, int K, int K2, int P, void* stream) {
  int nt = 64;
  size_t smem = sizeof(T) * (size_t)(5 * K + 1) * nt;
  while (smem > 227 * 1024 && nt > 32) {
    nt /= 2;
    smem = sizeof(T) * (size_t)(5 * K + 1) * nt;
  }
  auto kern = remap_kernel<T, CLS, NEG>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long cols = L * P;
  const unsigned blocks = (unsigned)((cols + nt - 1) / nt);
  kern<<<blocks, nt, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)pe1, (const T*)pe2, (T*)out, L, rep1, rep2, K, K2, P);
  return (int)cudaGetLastError();
}

template <typename T, bool NEG>
int launch_sign(int cls, const void* q, const void* pe1, const void* pe2, void* out,
                long long L, int rep1, int rep2, int K, int K2, int P, void* stream) {
  switch (cls) {
    case 6: return launch_one<T, 6, NEG>(q, pe1, pe2, out, L, rep1, rep2, K, K2, P, stream);
    case 7: return launch_one<T, 7, NEG>(q, pe1, pe2, out, L, rep1, rep2, K, K2, P, stream);
    case 8: return launch_one<T, 8, NEG>(q, pe1, pe2, out, L, rep1, rep2, K, K2, P, stream);
    case 9: return launch_one<T, 9, NEG>(q, pe1, pe2, out, L, rep1, rep2, K, K2, P, stream);
    case 10: return launch_one<T, 10, NEG>(q, pe1, pe2, out, L, rep1, rep2, K, K2, P, stream);
    default: return -1;
  }
}

template <typename T>
int launch(const void* q, const void* pe1, const void* pe2, void* out, long long L,
           int rep1, int rep2, int K, int K2, int P, int kord, void* stream) {
  const int ak = kord < 0 ? -kord : kord;
  const int cls = ak <= 6 ? 6 : (ak >= 10 ? 10 : ak);
  return kord < 0 ? launch_sign<T, true>(cls, q, pe1, pe2, out, L, rep1, rep2, K, K2, P, stream)
                  : launch_sign<T, false>(cls, q, pe1, pe2, out, L, rep1, rep2, K, K2, P, stream);
}

}  // namespace

// q (L, K, P), pe1 (L / rep1, K+1, P), pe2 (L / rep2, K2, P), out
// (L, K2-1, P), all contiguous device arrays; P = Y * X.
extern "C" int pace_remap_f32(const void* q, const void* pe1, const void* pe2, void* out,
                              long long L, int rep1, int rep2, int K, int K2, int P,
                              int kord, void* stream) {
  return launch<float>(q, pe1, pe2, out, L, rep1, rep2, K, K2, P, kord, stream);
}

extern "C" int pace_remap_f64(const void* q, const void* pe1, const void* pe2, void* out,
                              long long L, int rep1, int rep2, int K, int K2, int P,
                              int kord, void* stream) {
  return launch<double>(q, pe1, pe2, out, L, rep1, rep2, K, K2, P, kord, stream);
}
