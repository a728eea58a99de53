// Lagrangian -> Eulerian vertical remap: a block per tile of columns, the
// levels spread over the block's threads.
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
// 3.35 TB/s); a nine-tracer block, with the columns counted once, about 1582
// planes, 1.49 GB, 0.44 ms.
// Design: a block owns TC adjacent columns (32 in f32, 16 in f64: 128-byte
// rows) of one group of G fields that share their pressure columns (G = 9
// for the tracer block, 1 for a field) and 256 threads, blockDim (TC, 256 /
// TC): threadIdx.x is the column, threadIdx.y walks the levels. Every array
// lives in shared memory as [level][column], so each warp reads and writes
// whole rows and shared memory scales with the tile's columns, not with the
// threads; the columns arrive by cp.async (16-byte pieces where the rows are
// 16-byte aligned). Once per group the block fetches pe1, pe2 and the first
// field's q together and finds each target interface's source cell idx (in
// parallel over target and column); the G fields reuse pe1, pe2 and idx.
// Per field: q with two ghost levels at each end (the rolls' wrapped values,
// so that stencils read fixed offsets); the running integral Q1 by one
// thread per column in the plain version's order (a tree-ordered scan would
// move the thin layers' differences); then the target means in parallel,
// each thread over a contiguous run of targets, carrying the integral at the
// run's previous interface: for each target the PPM coefficients of its
// cell are formed from q at idx-2 .. idx+2 alone (interface values,
// one-sided ends, constraint), so no coefficient is kept in shared memory.
// In f32 at K = 79 a tile holds 4 K values and K indices a column, 46 KB,
// and 57-64 registers a thread: four blocks, 1024 threads, an SM.
// What holds it (NVIDIA H100 80GB HBM3, C192 npz=79 f32): instruction issue
// of the per-target reconstruction (three true divisions and the kord
// class's limiters a target) and the sequential Q1, which leaves one warp of
// eight busy; it moves its bound's bytes at about a quarter of the card's
// memory rate (tools/torch_kernel_ab.py, PERF.md). The kernel is templated
// on the kord class and its sign.

#include <cuda_runtime.h>

namespace {

constexpr int D_OFFSET = 5;
constexpr int kThreads = 256;

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

// _limited_slope of ops/ppm.py at the middle of three cells
template <typename T>
__device__ __forceinline__ T limited_slope(T qm, T q0, T qp) {
  const T dm = T(0.5) * (qp - qm);
  const T dq_r = qp - q0, dq_l = q0 - qm;
  const T lim = vmin(vabs(dm), T(2) * vmin(vabs(dq_r), vabs(dq_l)));
  const T sgn = dm > T(0) ? T(1) : (dm < T(0) ? T(-1) : T(0));
  return dq_r * dq_l > T(0) ? sgn * lim : T(0);
}

// the unlimited cubic interface value between cells qm1 and q0, clamped to
// its stencil's range widened by that range (_al_unlimited and the guard)
template <typename T>
__device__ __forceinline__ T clamped_cubic(T qm2, T qm1, T q0, T qp1) {
  const T al = T(7.0 / 12.0) * (qm1 + q0) - T(1.0 / 12.0) * (qm2 + qp1);
  const T lo = vmin(vmin(q0, qm1), vmin(qm2, qp1));
  const T hi = vmax(vmax(q0, qm1), vmax(qm2, qp1));
  const T r = hi - lo;
  return vclamp(al, lo - r, hi + r);
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

// shared-memory bytes of a tile of tc columns: q with two ghost levels at
// each end (K + 4), Q1 (K), pe1 (K + 1), pe2 (K2), then idx (K2)
template <typename T>
size_t tile_bytes(int tc, int K, int K2) {
  const size_t vals = (size_t)(K + 4) + K + (K + 1) + K2;
  return tc * (vals * sizeof(T) + (size_t)K2 * sizeof(unsigned short));
}

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
               "n"(sizeof(T)));
}
// 16 bytes, past L1
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// rows [0, n) of a [level][column] tile array at dst (row r at dst + r TC)
// from src (level r at src + r P), the tile's first nc columns; whole
// 16-byte pieces where vec (P and the arrays 16-byte aligned)
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int n, int TC, int nc, int P,
                                          bool vec) {
  const int NT = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  constexpr int V = 16 / sizeof(T);
  const int pieces = vec ? nc / V : 0;  // per row
  for (int e = tid; e < n * pieces; e += NT) {
    const int r = e / pieces, cv = (e - r * pieces) * V;
    cp_async16(dst + r * TC + cv, src + (long long)r * P + cv);
  }
  const int rest = nc - pieces * V;
  for (int e = tid; e < n * rest; e += NT) {
    const int r = e / rest, cc = pieces * V + (e - r * rest);
    cp_async(dst + r * TC + cc, src + (long long)r * P + cc);
  }
}

// wait for this thread's copies, then make every thread's visible
__device__ __forceinline__ void cp_async_join() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
}

// The PPM coefficients (a_l, d_a, a6) of cell k of one column, from q at
// k-2 .. k+2 alone (qk points at level k of a [level][column] array whose
// stride between levels is TC and which holds the two wrapped ghost levels
// at each end): the interface values at k and k+1, bl/br with the one-sided
// column ends, the constraint of the kord class (vertical_reconstruction)
template <typename T, int CLS, bool NEG>
__device__ __forceinline__ void coefficients(const T* qk, const T* q0c, int k, int K, int TC,
                                             T& a_l, T& d_a, T& a6) {
  const T qa = qk[-2 * TC], qb = qk[-TC], q0 = qk[0], qd = qk[TC], qe = qk[2 * TC];
  // interface values above cells k and k+1
  T al_k, al_k1;
  if (CLS <= 8) {
    const T sb_ = limited_slope(qa, qb, q0), s0 = limited_slope(qb, q0, qd);
    const T sd = limited_slope(q0, qd, qe);
    al_k = T(0.5) * (qb + q0) + (sb_ - s0) / T(6);
    al_k1 = T(0.5) * (q0 + qd) + (s0 - sd) / T(6);
  } else {
    al_k = clamped_cubic(qa, qb, q0, qd);
    al_k1 = clamped_cubic(qb, q0, qd, qe);
  }
  T bl = al_k - q0;
  T br = al_k1 - q0;
  // the one-sided column ends
  if (K < 3) {
    bl = T(0);
    br = T(0);
  } else if (k <= 1 || k >= K - 2) {
    const T c0 = q0c[0], c1 = q0c[TC], c2 = q0c[2 * TC];
    const T qm1 = q0c[(K - 1) * TC], qm2 = q0c[(K - 2) * TC], qm3 = q0c[(K - 3) * TC];
    T al0 = ((T(11) * c0 - T(7) * c1) + T(2) * c2) / T(6);
    T al1 = ((T(2) * c0 + T(5) * c1) - c2) / T(6);
    T alK = ((T(11) * qm1 - T(7) * qm2) + T(2) * qm3) / T(6);
    T alK1 = ((T(2) * qm1 + T(5) * qm2) - qm3) / T(6);
    if (CLS <= 8) {
      const T lo01 = vmin(c0, c1), hi01 = vmax(c0, c1);
      const T loK = vmin(qm1, qm2), hiK = vmax(qm1, qm2);
      al0 = vclamp(al0, lo01, hi01);
      al1 = vclamp(al1, lo01, hi01);
      alK = vclamp(alK, loK, hiK);
      alK1 = vclamp(alK1, loK, hiK);
    }
    if (k == 0) bl = al0 - c0;
    else if (k == 1) bl = al1 - c1;
    else if (k == K - 1) bl = alK1 - qm1;
    if (k == 0) br = al1 - c0;
    else if (k == K - 2) br = alK1 - qm2;
    else if (k == K - 1) br = alK - qm1;
  }
  // the constraint of the kord class
  if (CLS <= 6) {
    monotone(bl, br);
  } else {
    bool sel;
    if (CLS == 7) {
      sel = k <= 1 || k >= K - 2;
    } else {  // noise mask (_noise_mask) at k-1, k, k+1
      const T dqm0 = qb - qa, dqp0 = q0 - qb;
      const T dqm1 = q0 - qb, dqp1 = qd - q0;
      const T dqm2 = qd - q0, dqp2 = qe - qd;
      const bool ext0 = dqm0 * dqp0 <= T(0), ext1 = dqm1 * dqp1 <= T(0);
      const bool ext2 = dqm2 * dqp2 <= T(0);
      const T d20 = dqp0 - dqm0, d21 = dqp1 - dqm1, d22 = dqp2 - dqm2;
      const bool smooth = (d21 * d20 > T(0)) && (d21 * d22 > T(0));
      sel = ext1 && !smooth;
      if (CLS >= 10) sel = sel && (ext0 || ext2);
      sel = sel || k <= 1 || k >= K - 2;
    }
    if (sel)
      monotone(bl, br);
    else
      overshoot(bl, br);
  }
  if (NEG) positive(q0, bl, br);
  a_l = q0 + bl;
  d_a = br - bl;
  a6 = T(-3) * (bl + br);
}

template <typename T, int CLS, bool NEG>
__global__ void __launch_bounds__(kThreads) remap_kernel(
    const T* __restrict__ q, const T* __restrict__ pe1, const T* __restrict__ pe2,
    T* __restrict__ out, int G, int rep1, int rep2, int K, int K2, int P, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int TC = blockDim.x, NJ = blockDim.y;
  const int c = threadIdx.x, ty = threadIdx.y;
  const int p0 = blockIdx.x * TC;
  const int nc = P - p0 < TC ? P - p0 : TC;
  const bool active = c < nc;  // the ragged last tile
  const long long l0 = (long long)blockIdx.y * G;
  // [level][column] arrays; sq's level k is row k + 2 (rows 0, 1 and K+2,
  // K+3 hold the levels -2, -1, K, K+1 wrapped into the column, as the
  // plain version's rolls wrap)
  T* sq = reinterpret_cast<T*>(smem_raw);  // q
  T* sQ1 = sq + (K + 4) * TC;              // the running integral at the cell tops
  T* spe = sQ1 + K * TC;                   // pe1
  T* spe2 = spe + (K + 1) * TC;            // pe2
  unsigned short* sidx = reinterpret_cast<unsigned short*>(spe2 + K2 * TC);
#define SH(a, k) a[(k) * TC + c]
#define SQ(k) sq[((k) + 2) * TC + c]
  // k wrapped into the column (within one column length of it, so no
  // division is needed; columns of fewer than 3 cells take the modulo)
  auto w = [K](int k) {
    return K >= 3 ? (k < 0 ? k + K : (k >= K ? k - K : k)) : ((k % K) + K) % K;
  };
  // field l's q, with the ghost levels, into sq
  auto load_q = [&](long long l) {
    const T* ql = q + l * K * P + p0;
    load_rows(sq + 2 * TC, ql, K, TC, nc, P, vec);
    if (active && ty < 4) {
      const int kg = ty < 2 ? ty - 2 : K + ty - 2;  // -2, -1, K, K+1
      cp_async(&SQ(kg), ql + c + (long long)w(kg) * P);
    }
  };

  // --- once per group: the pressure columns and each target's cell; the
  //     first field's q is fetched with them
  {
    load_rows(spe, pe1 + (l0 / rep1) * (long long)(K + 1) * P + p0, K + 1, TC, nc, P, vec);
    load_rows(spe2, pe2 + (l0 / rep2) * (long long)K2 * P + p0, K2, TC, nc, P, vec);
    load_q(l0);
    cp_async_join();
    if (active)
      for (int j = ty; j < K2; j += NJ) {
        const T pj = SH(spe2, j);
        const int base = j - 1 < 0 ? 0 : (j - 1 > K - 1 ? K - 1 : j - 1);
        int m_loc = 0;
#pragma unroll
        for (int o = -D_OFFSET; o <= D_OFFSET; ++o) {
          const int kk = base + o;
          if (kk < 0 || kk > K - 1) continue;
          const int cmp = SH(spe, kk + 1) <= pj ? 1 : 0;
          m_loc += o < 0 ? cmp - 1 : cmp;
        }
        const int off = m_loc < -D_OFFSET ? -D_OFFSET : (m_loc > D_OFFSET ? D_OFFSET : m_loc);
        const int idx = j - 1 + off;
        SH(sidx, j) = (unsigned short)(idx < 0 ? 0 : (idx > K - 1 ? K - 1 : idx));
      }
    __syncthreads();
  }

  // each thread's contiguous run of targets in the last phase
  const int per = (K2 - 1 + NJ - 1) / NJ;
  const int j_lo = 1 + ty * per;
  const int j_hi = j_lo + per < K2 ? j_lo + per : K2;
  auto q_int = [&](int j) {  // the integral at target interface j
    const int idx = SH(sidx, j);
    T a_l, d_a, a6;
    coefficients<T, CLS, NEG>(&SQ(idx), &SQ(0), idx, K, TC, a_l, d_a, a6);
    const T pe1_m = SH(spe, idx);
    const T dp1_m = SH(spe, idx + 1) - pe1_m;
    const T tt = vclamp((SH(spe2, j) - pe1_m) / dp1_m, T(0), T(1));
    const T t2 = tt * tt;
    const T t3 = t2 * tt;
    const T f = (a_l * tt + (T(0.5) * d_a) * t2) + a6 * (T(0.5) * t2 - t3 / T(3));
    return SH(sQ1, idx) + dp1_m * f;
  };

  for (int g = 0; g < G; ++g) {
    const long long l = l0 + g;
    T* oc = out + l * (long long)(K2 - 1) * P + p0 + c;
    if (g > 0) {
      load_q(l);
      cp_async_join();
    }

    // running integral at the cell tops, in sequence
    if (active && ty == 0) {
      T acc = T(0);
#pragma unroll 8
      for (int k = 0; k < K; ++k) {
        const T qdp = SQ(k) * (SH(spe, k + 1) - SH(spe, k));
        SH(sQ1, k) = acc;
        acc = k == 0 ? qdp : acc + qdp;
      }
    }
    __syncthreads();

    // each target cell's reconstruction and integral, and the differences
    // of the integrals over the target thicknesses
    if (active && j_lo < j_hi) {
      T q_prev = q_int(j_lo - 1);
      for (int j = j_lo; j < j_hi; ++j) {
        const T qi = q_int(j);
        oc[(long long)(j - 1) * P] = (qi - q_prev) / (SH(spe2, j) - SH(spe2, j - 1));
        q_prev = qi;
      }
    }
    __syncthreads();  // the next field overwrites sq
  }
#undef SQ
#undef SH
}

int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

template <typename T, int CLS, bool NEG>
int launch_one(const void* q, const void* pe1, const void* pe2, void* out, long long L,
               int rep1, int rep2, int K, int K2, int P, void* stream) {
  if (K > 65535) return -1;
  int tc = sizeof(T) == 4 ? 32 : 16;
  while (tile_bytes<T>(tc, K, K2) > 227 * 1024 && tc > 1) tc /= 2;
  const size_t smem = tile_bytes<T>(tc, K, K2);
  if (smem > 227 * 1024) return -1;
  // fields that share both pressure columns: a group, one block row
  const int G = gcd(rep1, rep2);
  const long long groups = L / G;
  if (groups > 65535) return -1;
  auto kern = remap_kernel<T, CLS, NEG>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((P + tc - 1) / tc), (unsigned)groups);
  const dim3 block(tc, kThreads / tc);
  // whole 16-byte pieces where every level row starts 16-byte aligned
  const bool vec = (P * sizeof(T)) % 16 == 0 && ((size_t)q | (size_t)pe1 | (size_t)pe2) % 16 == 0;
  kern<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)pe1, (const T*)pe2, (T*)out, G, rep1, rep2, K, K2, P, vec);
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
