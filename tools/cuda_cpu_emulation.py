#!/usr/bin/env python3
"""Build a kernel source of ``pace_tpu_torch/csrc`` for the CPU, to check a
rewrite of a kernel bit for bit against an earlier revision without a card.

The source is compiled by ``g++`` (C++20) against a small emulation of the
CUDA pieces the kernels use: blocks run one after another, the threads of a
block as ``std::thread``s that meet at a ``std::barrier`` in
``__syncthreads()``, dynamic shared memory is one buffer refilled with NaN
before each block (static ``__shared__`` variables become ``static``),
``cp.async`` is a plain copy and the other inline PTX is dropped. The
library exports the same C functions as the card's, and takes host pointers
(``tensor.data_ptr()`` of CPU tensors) and any stream value.

Run from the repository root::

    python3 tools/cuda_cpu_emulation.py pace_tpu_torch/csrc/sim1.cu build/emu/libsim1.so
    git show <rev>:pace_tpu_torch/csrc/sim1.cu > build/emu/sim1_prev.cu
    python3 tools/cuda_cpu_emulation.py build/emu/sim1_prev.cu build/emu/libsim1_prev.so

then load both with ``ctypes`` and call them on the same CPU tensors.

What it shows: index arithmetic, tiling, the barriers' placement (a missing
barrier may or may not show, as on the card) and the operation order, which
``-ffp-contract=off`` keeps as the card's ``-fmad=false`` does. What it does
not: ``logf``/``log`` and the other library functions round as the host's C
library does, so a float32 kernel that calls them agrees with the card's only
where they do; timing means nothing.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from pathlib import Path

SHIM = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstring>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static  // one block at a time: a static is the block's
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* emu_barrier = nullptr;
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
alignas(16) inline unsigned char emu_smem[1 << 18];
#define smem_raw emu_smem
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 0;
template <typename F>
inline int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }
inline unsigned long __cvta_generic_to_shared(const void* p) { return (unsigned long)p; }
template <typename K, typename... A>
inline void emu_launch(K kern, dim3 grid, dim3 block, size_t smem, void*, A... args) {
  if (smem > sizeof(emu_smem)) throw 1;
  blockDim = block;
  gridDim = grid;
  const unsigned nt = block.x * block.y * block.z;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::memset(emu_smem, 0xff, sizeof(emu_smem));
        std::barrier<> bar(nt);
        emu_barrier = &bar;
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < nt; ++t)
          threads.emplace_back([&, t] {
            blockIdx = dim3(bx, by, bz);
            threadIdx = dim3(t % block.x, (t / block.x) % block.y, t / (block.x * block.y));
            kern(args...);
          });
        for (auto& th : threads) th.join();
      }
}
"""


def transform(src: str) -> str:
    """The kernel source with the CUDA-only constructs replaced."""
    src = src.replace("extern __shared__ unsigned char smem_raw[];", "")
    src = re.sub(r'asm volatile\("cp\.async\.c[ag]\.shared\.global.*?\);', "*dst = *src;", src,
                 flags=re.S)
    src = re.sub(r"asm volatile\(.*?\);", "(void)0;", src, flags=re.S)
    return re.sub(r"(\w+(?:<[^<>]*>)?)<<<([^>]*)>>>\(", r"emu_launch(\1, \2, ", src)


def build(source: Path, out: Path) -> Path:
    """Compile ``source`` for the CPU into the shared library ``out``."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the CPU emulation cannot be built")
    work = out.parent / (out.stem + "_emu")
    work.mkdir(parents=True, exist_ok=True)
    (work / "cuda_runtime.h").write_text(SHIM)
    cpp = work / (source.stem + ".cpp")
    cpp.write_text(transform(source.read_text()))
    cmd = [cxx, "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC", "-shared", f"-I{work}",
           "-o", str(out), str(cpp), "-lpthread"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed on {source}:\n{res.stderr}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("source", type=Path)
    ap.add_argument("out", type=Path)
    args = ap.parse_args()
    print(build(args.source, args.out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
