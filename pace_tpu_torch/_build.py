"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into its own
shared library with a plain C interface, loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds. Libraries land in
``build/kernels/`` at the repository root, named by a hash of the source and
the flags, and are built at first use (or all at once, in parallel, by
:func:`build`). Nothing here runs at import time: the CPU tests import every
module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"

#: kernel library name -> source file under csrc/
SOURCES = {
    "halo": "halo.cu",
    "fvtp2d": "fvtp2d.cu",
    "d2a2c": "d2a2c.cu",
    "c_sw_tail": "c_sw_tail.cu",
    "d_sw_tail": "d_sw_tail.cu",
    "hydro": "hydro.cu",
    "updatedz": "updatedz.cu",
    "sim1": "sim1.cu",
    "pgrad": "pgrad.cu",
    "remap": "remap.cu",
}

# -fmad=false: no multiply-add contraction, so the kernels round op for op
# like the plain PyTorch versions (one rounding per elementwise op)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
#: name -> compiler output (ptxas register/shared-memory report) of the
#: last build made by this process
BUILD_LOG: Dict[str, str] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        Path(cuda_home) / "bin" / "nvcc" if cuda_home else None,
        Path("/usr/local/cuda/bin/nvcc"),
    ):
        if cand is not None and cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _target(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    h = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libpace_{name}-{h}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernel libraries that are not built yet, one
    ``nvcc`` process per source, all started together. Returns the wall
    seconds per library built; raises with the compiler output on failure."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            out,
        )
    times = {}
    failed = []
    for name, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        times[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if p.returncode != 0:
            failed.append(f"--- {name} (nvcc rc={p.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return times


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib


def stream_handle(device) -> ctypes.c_void_p:
    """The current torch CUDA stream of ``device`` as a ctypes pointer."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(rc: int, what: str) -> None:
    """Raise if a launcher returned a non-zero ``cudaGetLastError()``."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error code {rc}")
