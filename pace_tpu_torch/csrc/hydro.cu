// Hydrostatic interface chain, one thread per column.
//
// Replaces pace_tpu/ops/hydro_pallas.py `_kernel` (pallas_call at :118,
// entry hydrostatic_interfaces_pallas :140): from layer thickness delp and
// potential temperature pt (S, K, Y, X) and surface geopotential phis
// (S, Y, X) it produces any of
//   pe   (K+1) interface pressure, pe[0] = ptop, ascending sum of delp
//   peln (K+1) log(pe)
//   pk   (K+1) (pe / P_REF)^kappa
//   pkz  (K)   (pk[k+1] - pk[k]) / (kappa * (peln[k+1] - peln[k]))
//   gz   (K+1) interface geopotential, gz[K] = phis, descending sum of
//              cp * pt[k] * (pk[k+1] - pk[k])
// A null output pointer means "not asked for": nothing is written for it,
// and pt and phis are read only for gz. The sums run sequentially in k, in
// the order of the plain version's cumulative sums (ops/pgrad.py
// hydrostatic_interfaces); log and pow are the full-precision library
// functions (no fast-math), because pkz cancels: an ulp of pk or peln grows
// by pk/dpk or peln/dpeln.
//
// Bound on an H100: bytes. The nonhydrostatic step's forms move delp in and
// pkz (and pk) out: ~0.15 GB, ~0.044 ms at 3.35 TB/s for a C192 npz=79 f32
// call (pk and pkz ~0.067 ms); the hydrostatic step's pk, pkz, gz ~0.11 ms.
// Close behind is instruction issue: each interface point takes one logf,
// one powf (which forms a logarithm of its own in extended precision) and
// two IEEE divisions.
// Design: one thread per column (s, y, x), x fastest, so the loads of a
// warp at one level are whole 128-byte lines. The upward walk carries pe,
// peln and pk of the previous interface in registers.
// - Without gz (hydro_kernel, the nonhydrostatic step's forms): delp comes
//   in chunks of kChunk levels, copied by cp.async into the thread's own
//   shared-memory slots, the next chunk in flight while the current one is
//   computed; a thread reads only what it copied, so no barrier is needed.
//   Loading delp level by level, a few loads in flight a thread, a design
//   took 0.099 ms a C192 npz=79 f32 call on an H100 with its math left out.
//   At most 32 registers (16 blocks of 128 threads an SM) hold the C192
//   grid's 235,224 columns in one wave.
// - With gz (hydro_gz_kernel, the hydrostatic step's form, unchanged from
//   the earlier design): the per-layer contribution waits in shared memory
//   ([level][thread], conflict-free) for the downward walk, so no output is
//   read back and pt is read once.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // threads a block, one column each
constexpr int kChunk = 4;      // levels of delp a copy brings
// blocks an SM the registers must allow (16 x 128 threads: 32 registers)
template <typename T>
constexpr int min_blocks() {
  return sizeof(T) == 8 ? 8 : 16;
}
constexpr int kGzThreads = 64;  // threads a block of the gz form

template <typename T>
__device__ __forceinline__ T vlog(T x);
template <>
__device__ __forceinline__ float vlog<float>(float x) { return logf(x); }
template <>
__device__ __forceinline__ double vlog<double>(double x) { return log(x); }

template <typename T>
__device__ __forceinline__ T vpow(T x, T y);
template <>
__device__ __forceinline__ float vpow<float>(float x, float y) { return powf(x, y); }
template <>
__device__ __forceinline__ double vpow<double>(double x, double y) { return pow(x, y); }

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
               "n"(sizeof(T)));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, min_blocks<T>()) hydro_kernel(
    const T* __restrict__ delp, T ptop, T p_ref, T kappa, T* __restrict__ pe_o,
    T* __restrict__ peln_o, T* __restrict__ pk_o, T* __restrict__ pkz_o, int S,
    int K, int P) {
  __shared__ T s_d[2][kChunk][kThreads];  // two chunks of the thread's delp

  const long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (col >= (long long)S * P) return;
  const int s = (int)(col / P);
  const int p = (int)(col - (long long)s * P);
  const T* dp = delp + (long long)s * K * P + p;
  const long long o1 = (long long)s * (K + 1) * P + p;  // (K+1)-level outputs
  const long long o0 = (long long)s * K * P + p;        // K-level outputs
  // chunk c of the column's delp into buffer c & 1; one commit group a
  // chunk (empty past the last), so waiting for all but the newest group
  // waits for exactly the chunk needed
  auto copy = [&](int c) {
    const int k0 = c * kChunk;
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (k0 + j < K) cp_async(&s_d[c & 1][j][threadIdx.x], dp + (long long)(k0 + j) * P);
    cp_async_commit();
  };
  copy(0);

  T acc = T(0);
  T pe = ptop;
  T peln = vlog<T>(pe);
  T pk = vpow<T>(pe / p_ref, kappa);
  if (pe_o) pe_o[o1] = pe;
  if (peln_o) peln_o[o1] = peln;
  if (pk_o) pk_o[o1] = pk;
  const int chunks = (K + kChunk - 1) / kChunk;
  for (int c = 0; c < chunks; ++c) {
    copy(c + 1);  // into the buffer chunk c-1 was read from
    cp_async_wait_1();
    const int k0 = c * kChunk;
    const int n = K - k0 < kChunk ? K - k0 : kChunk;
#pragma unroll 2
    for (int j = 0; j < n; ++j) {
      const int k = k0 + j;
      acc = acc + s_d[c & 1][j][threadIdx.x];
      pe = ptop + acc;
      const T peln_n = vlog<T>(pe);
      const T pk_n = vpow<T>(pe / p_ref, kappa);
      const long long o = o1 + (long long)(k + 1) * P;
      if (pe_o) pe_o[o] = pe;
      if (peln_o) peln_o[o] = peln_n;
      if (pk_o) pk_o[o] = pk_n;
      if (pkz_o) pkz_o[o0 + (long long)k * P] = (pk_n - pk) / (kappa * (peln_n - peln));
      peln = peln_n;
      pk = pk_n;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kGzThreads) hydro_gz_kernel(
    const T* __restrict__ delp, const T* __restrict__ pt,
    const T* __restrict__ phis, T ptop, T p_ref, T kappa, T cp_air,
    T* __restrict__ pe_o, T* __restrict__ peln_o, T* __restrict__ pk_o,
    T* __restrict__ pkz_o, T* __restrict__ gz_o, int S, int K, int P) {
  extern __shared__ unsigned char smem_raw[];
  T* s_c = reinterpret_cast<T*>(smem_raw);  // [K][kGzThreads]

  const long long col = (long long)blockIdx.x * kGzThreads + threadIdx.x;
  if (col >= (long long)S * P) return;
  const int s = (int)(col / P);
  const int p = (int)(col - (long long)s * P);
  const T* dp = delp + (long long)s * K * P + p;
  const long long o1 = (long long)s * (K + 1) * P + p;  // (K+1)-level outputs
  const long long o0 = (long long)s * K * P + p;        // K-level outputs
  const T* tp = pt + (long long)s * K * P + p;

  T acc = T(0);
  T pe = ptop;
  T peln = vlog<T>(pe);
  T pk = vpow<T>(pe / p_ref, kappa);
  if (pe_o) pe_o[o1] = pe;
  if (peln_o) peln_o[o1] = peln;
  if (pk_o) pk_o[o1] = pk;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    acc = acc + dp[(long long)k * P];
    pe = ptop + acc;
    const T peln_n = vlog<T>(pe);
    const T pk_n = vpow<T>(pe / p_ref, kappa);
    const long long o = o1 + (long long)(k + 1) * P;
    if (pe_o) pe_o[o] = pe;
    if (peln_o) peln_o[o] = peln_n;
    if (pk_o) pk_o[o] = pk_n;
    const T dpk = pk_n - pk;
    if (pkz_o) pkz_o[o0 + (long long)k * P] = dpk / (kappa * (peln_n - peln));
    s_c[k * kGzThreads + threadIdx.x] = cp_air * tp[(long long)k * P] * dpk;
    peln = peln_n;
    pk = pk_n;
  }
  const T ph = phis[col];
  gz_o[o1 + (long long)K * P] = ph;
  T sum = T(0);
  for (int k = K - 1; k >= 0; --k) {
    sum = sum + s_c[k * kGzThreads + threadIdx.x];
    gz_o[o1 + (long long)k * P] = ph + sum;
  }
}

template <typename T>
int launch(const void* delp, const void* pt, const void* phis, double ptop,
           double p_ref, double kappa, double cp_air, void* pe, void* peln,
           void* pk, void* pkz, void* gz, int S, int K, int P, void* stream) {
  const long long cols = (long long)S * P;
  if (!gz) {
    const unsigned blocks = (unsigned)((cols + kThreads - 1) / kThreads);
    hydro_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const T*)delp, (T)ptop, (T)p_ref, (T)kappa, (T*)pe, (T*)peln, (T*)pk, (T*)pkz,
        S, K, P);
    return (int)cudaGetLastError();
  }
  const size_t smem = sizeof(T) * (size_t)K * kGzThreads;
  auto kern = hydro_gz_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((cols + kGzThreads - 1) / kGzThreads);
  kern<<<blocks, kGzThreads, smem, (cudaStream_t)stream>>>(
      (const T*)delp, (const T*)pt, (const T*)phis, (T)ptop, (T)p_ref, (T)kappa,
      (T)cp_air, (T*)pe, (T*)peln, (T*)pk, (T*)pkz, (T*)gz, S, K, P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pace_hydro_f32(const void* delp, const void* pt, const void* phis,
                              double ptop, double p_ref, double kappa,
                              double cp_air, void* pe, void* peln, void* pk,
                              void* pkz, void* gz, int S, int K, int P,
                              void* stream) {
  return launch<float>(delp, pt, phis, ptop, p_ref, kappa, cp_air, pe, peln, pk,
                       pkz, gz, S, K, P, stream);
}

extern "C" int pace_hydro_f64(const void* delp, const void* pt, const void* phis,
                              double ptop, double p_ref, double kappa,
                              double cp_air, void* pe, void* peln, void* pk,
                              void* pkz, void* gz, int S, int K, int P,
                              void* stream) {
  return launch<double>(delp, pt, phis, ptop, p_ref, kappa, cp_air, pe, peln, pk,
                        pkz, gz, S, K, P, stream);
}
