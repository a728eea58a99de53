// Native IO core of the port's NetCDF-3 codec (pace_tpu_torch/utils/
// netcdf3.py), a copy of pace_tpu's: classic NetCDF stores big-endian
// payloads, and converting multi-GB restart, diagnostics and savepoint
// payloads to and from the host's byte order is the host-side cost of IO.
//
// A tiny C ABI loaded with ctypes:
//   pace_byteswap   - multithreaded endian swap (2/4/8-byte elements)
//   pace_swap_write - swap + pwrite directly to a file descriptor,
//                     bypassing the Python-side bytes copy
//   pace_swap_read  - pread + swap into a caller buffer
//
// Build: g++ -O3 -march=native -shared -fPIC -pthread, at first use into
// build/native/ (pace_tpu_torch/utils/native.py); without a compiler the
// numpy path runs instead and writes the same bytes.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#include <algorithm>

#include <fcntl.h>
#include <unistd.h>

namespace {

inline uint16_t bswap(uint16_t v) { return __builtin_bswap16(v); }
inline uint32_t bswap(uint32_t v) { return __builtin_bswap32(v); }
inline uint64_t bswap(uint64_t v) { return __builtin_bswap64(v); }

template <typename T>
void swap_range(T* dst, const T* src, long long n) {
  for (long long i = 0; i < n; ++i) dst[i] = bswap(src[i]);
}

// Split [0, n) across up to `threads` workers; tiny inputs stay serial.
template <typename T>
void swap_parallel(T* dst, const T* src, long long n) {
  const long long kSerialCutoff = 1 << 20;  // elements
  unsigned hw = std::thread::hardware_concurrency();
  unsigned threads = std::min<unsigned>(hw ? hw : 1, 8);
  if (n < kSerialCutoff || threads <= 1) {
    swap_range(dst, src, n);
    return;
  }
  std::vector<std::thread> pool;
  long long chunk = (n + threads - 1) / threads;
  for (unsigned t = 0; t < threads; ++t) {
    long long lo = t * chunk;
    long long hi = std::min<long long>(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back([=] { swap_range(dst + lo, src + lo, hi - lo); });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Endian-swap n elements of size elem (1, 2, 4 or 8 bytes) from src to dst.
// dst == src is allowed (in-place). Returns 0 on success.
int pace_byteswap(void* dst, const void* src, long long n, int elem) {
  switch (elem) {
    case 1:
      if (dst != src) std::memcpy(dst, src, (size_t)n);
      return 0;
    case 2:
      swap_parallel((uint16_t*)dst, (const uint16_t*)src, n);
      return 0;
    case 4:
      swap_parallel((uint32_t*)dst, (const uint32_t*)src, n);
      return 0;
    case 8:
      swap_parallel((uint64_t*)dst, (const uint64_t*)src, n);
      return 0;
    default:
      return -1;
  }
}

// Swap (if do_swap) and pwrite n elements at byte `offset` of fd.
// Returns bytes written, or -1 on error.
long long pace_swap_write(int fd, long long offset, const void* src,
                          long long n, int elem, int do_swap) {
  const char* buf = (const char*)src;
  std::vector<char> tmp;
  if (do_swap && elem > 1) {
    tmp.resize((size_t)(n * elem));
    if (pace_byteswap(tmp.data(), src, n, elem) != 0) return -1;
    buf = tmp.data();
  }
  long long total = n * elem;
  long long done = 0;
  while (done < total) {
    ssize_t w = pwrite(fd, buf + done, (size_t)(total - done), offset + done);
    if (w < 0) return -1;
    done += w;
  }
  return done;
}

// pread n elements at byte `offset` of fd into dst, then swap in place.
// Returns bytes read, or -1 on error (short reads are errors).
long long pace_swap_read(int fd, long long offset, void* dst, long long n,
                         int elem, int do_swap) {
  char* buf = (char*)dst;
  long long total = n * elem;
  long long done = 0;
  while (done < total) {
    ssize_t r = pread(fd, buf + done, (size_t)(total - done), offset + done);
    if (r < 0) return -1;
    if (r == 0) break;  // EOF
    done += r;
  }
  if (done != total) return -1;
  if (do_swap && elem > 1) {
    if (pace_byteswap(dst, dst, n, elem) != 0) return -1;
  }
  return done;
}

}  // extern "C"
