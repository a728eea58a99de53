// Halo exchange on the stacked shard axis as one gather pass.
//
// Replaces pace_tpu/parallel/halo_pallas.py `_halo_kernel` (pallas_call at
// halo_pallas.py:146; entries exchange_pallas_multi :165, exchange_pallas
// :261): every ghost strip of every shard is a rigidly rotated, possibly
// sign-flipped copy of a rectangle of one source shard's interior.
//
// Here the region ops are resolved on the host, once per (op set, shape),
// into a per-output-point index map (pace_tpu_torch/parallel/halo_kernel.py):
//   off[s, y, x]  = source offset within the source plane (y_src * X_in + x_src)
//   meta[s, y, x] = (source shard << 2) | (input id << 1) | (negate ? 1 : 0)
// Points no op touches map to themselves (copy-through); a region-only
// output (the y-fold corner pack) has every point mapped by its ops.
//
// Bound on an H100: bytes. The work is a copy with 0 flops per element; the
// least traffic is one read of each source element used and one write of
// each output element (the map adds 8 bytes per plane point, shared by all
// K levels: 8 / (K * 2 * sizeof(T)) of the traffic, 1.3% at K=79 f32).
// Design: one thread per output element and level, x fastest, so writes
// are fully coalesced and the interior (the bulk) reads coalesced too; the
// rotated ghost strips read strided, but they are O(h / Y) of the bytes.
// The grid is (plane blocks, K, S): no 64-bit divisions per element.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads) halo_gather(
    const T* __restrict__ in0, const T* __restrict__ in1, int P0, int P1,
    T* __restrict__ out, int Po, const int* __restrict__ off,
    const int* __restrict__ meta, int K) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= Po) return;
  const int k = blockIdx.y;
  const int s = blockIdx.z;
  const int m = s * Po + p;
  const int code = meta[m];
  const bool second = (code >> 1) & 1;
  const T* src = second ? in1 : in0;
  const long long P = second ? P1 : P0;
  const long long ss = code >> 2;
  const T v = src[(ss * K + k) * P + off[m]];
  out[((long long)s * K + k) * Po + p] = (code & 1) ? -v : v;
}

template <typename T>
int launch(const void* in0, const void* in1, int P0, int P1, void* out, int Po,
           const int* off, const int* meta, int S, int K, void* stream) {
  dim3 grid((Po + kThreads - 1) / kThreads, K, S);
  halo_gather<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)in0, (const T*)in1, P0, P1, (T*)out, Po, off, meta, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pace_halo_gather_f32(const void* in0, const void* in1, int P0,
                                    int P1, void* out, int Po, const int* off,
                                    const int* meta, int S, int K,
                                    void* stream) {
  return launch<float>(in0, in1, P0, P1, out, Po, off, meta, S, K, stream);
}

extern "C" int pace_halo_gather_f64(const void* in0, const void* in1, int P0,
                                    int P1, void* out, int Po, const int* off,
                                    const int* meta, int S, int K,
                                    void* stream) {
  return launch<double>(in0, in1, P0, P1, out, Po, off, meta, S, K, stream);
}
