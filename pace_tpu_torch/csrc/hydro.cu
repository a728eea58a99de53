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
// Bound on an H100: bytes (2 reads and 3 writes of a field for pk, pkz, gz:
// ~0.37 GB, ~0.11 ms at 3.35 TB/s for a C192 npz=79 f32 call; one log and
// one pow per interface point are ~0.02 ms of arithmetic).
// Design: one thread per column (s, y, x), x fastest, so the 32 loads of a
// warp at one level are one 128-byte line. The upward walk carries pe, peln
// and pk of the previous interface in registers; the per-layer gz
// contribution waits in shared memory ([level][thread], conflict-free) for
// the downward walk, so no output is read back and pt is read once.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

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
__global__ void __launch_bounds__(kThreads) hydro_kernel(
    const T* __restrict__ delp, const T* __restrict__ pt,
    const T* __restrict__ phis, T ptop, T p_ref, T kappa, T cp_air,
    T* __restrict__ pe_o, T* __restrict__ peln_o, T* __restrict__ pk_o,
    T* __restrict__ pkz_o, T* __restrict__ gz_o, int S, int K, int P) {
  extern __shared__ unsigned char smem_raw[];
  T* s_c = reinterpret_cast<T*>(smem_raw);  // [K][kThreads], only for gz

  const long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (col >= (long long)S * P) return;
  const int s = (int)(col / P);
  const int p = (int)(col - (long long)s * P);
  const T* dp = delp + (long long)s * K * P + p;
  const long long o1 = (long long)s * (K + 1) * P + p;  // (K+1)-level outputs
  const long long o0 = (long long)s * K * P + p;        // K-level outputs
  const bool want_gz = gz_o != nullptr;
  const T* tp = want_gz ? pt + (long long)s * K * P + p : nullptr;

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
    if (want_gz) s_c[k * kThreads + threadIdx.x] = cp_air * tp[(long long)k * P] * dpk;
    peln = peln_n;
    pk = pk_n;
  }
  if (want_gz) {
    const T ph = phis[col];
    gz_o[o1 + (long long)K * P] = ph;
    T sum = T(0);
    for (int k = K - 1; k >= 0; --k) {
      sum = sum + s_c[k * kThreads + threadIdx.x];
      gz_o[o1 + (long long)k * P] = ph + sum;
    }
  }
}

template <typename T>
int launch(const void* delp, const void* pt, const void* phis, double ptop,
           double p_ref, double kappa, double cp_air, void* pe, void* peln,
           void* pk, void* pkz, void* gz, int S, int K, int P, void* stream) {
  const size_t smem = gz ? sizeof(T) * (size_t)K * kThreads : 0;
  auto kern = hydro_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long cols = (long long)S * P;
  const unsigned blocks = (unsigned)((cols + kThreads - 1) / kThreads);
  kern<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
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
