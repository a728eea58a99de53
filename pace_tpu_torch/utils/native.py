"""Build and load the native (C++) IO core and expose numpy-friendly wrappers.

Port of ``pace_tpu.utils.native`` with the port's own copy of the source,
``_native/nc3core.cpp``: a multithreaded endian swap and direct
``pread``/``pwrite`` engine behind the NetCDF-3 codec (:mod:`.netcdf3`), where
converting multi-GB big-endian payloads is the host-side cost of IO. This is
host IO only: no device path and no kernel of the model.

The library is compiled with ``g++`` at first use into ``build/native/`` at
the repository root (named by a hash of the source, the flags and the host
CPU's features, since it is built with ``-march=native``; written to a
temporary name and renamed, so that concurrent processes never load a half
written file) and loaded through ctypes. Every caller tolerates ``lib() is
None`` and then takes the numpy path, which writes and reads the same bytes.

Set ``PACE_TPU_DISABLE_NATIVE=1`` to force the numpy path, as in ``pace_tpu``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "_native" / "nc3core.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib = None
_tried = False


def _cpu_flags() -> bytes:
    """The host CPU's feature flags: ``-march=native`` code is only valid on
    a CPU that has them, and a build directory may be copied to another
    machine."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return platform.processor().encode()


def _target() -> Path:
    key = _SRC.read_bytes() + " ".join(_FLAGS).encode() + _cpu_flags()
    return BUILD_DIR / f"libnc3core-{hashlib.sha1(key).hexdigest()[:12]}.so"


def _build(out: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = ["g++", *_FLAGS, "-o", str(tmp), str(_SRC)]
    try:
        res = subprocess.run(cmd, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    if res.returncode != 0 or not tmp.exists():
        return False
    os.replace(tmp, out)
    return True


def lib():
    """The loaded ctypes library, or None if unavailable/disabled."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    if _tried:
        return None
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("PACE_TPU_DISABLE_NATIVE"):
            return None
        try:
            so = _target()
            if not so.exists() and not _build(so):
                return None
            l = ctypes.CDLL(str(so))
            l.pace_byteswap.restype = ctypes.c_int
            l.pace_byteswap.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ]
            l.pace_swap_write.restype = ctypes.c_longlong
            l.pace_swap_write.argtypes = [
                ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ]
            l.pace_swap_read.restype = ctypes.c_longlong
            l.pace_swap_read.argtypes = [
                ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ]
            _lib = l
        except OSError:
            _lib = None
        return _lib


def available() -> bool:
    return lib() is not None


def _needs_swap(dtype: np.dtype) -> bool:
    bo = dtype.byteorder
    if bo == "=" or dtype.itemsize == 1:
        return False
    little = np.dtype("<i4").byteorder in ("=", "<")
    return (bo == ">" and little) or (bo == "<" and not little)


def to_native_endian(arr: np.ndarray) -> np.ndarray:
    """Return ``arr`` in native byte order (parallel swap when possible)."""
    arr = np.asarray(arr)
    if not _needs_swap(arr.dtype):
        return arr
    l = lib()
    src = np.ascontiguousarray(arr)
    out = np.empty(src.shape, dtype=src.dtype.newbyteorder("="))
    if l is None:
        out[...] = src.astype(out.dtype)
        return out
    rc = l.pace_byteswap(
        out.ctypes.data, src.ctypes.data, src.size, src.dtype.itemsize
    )
    if rc != 0:
        return src.astype(out.dtype)
    return out


def swap_write(fd: int, offset: int, arr: np.ndarray, big_endian_dtype) -> int:
    """Write ``arr`` at byte ``offset`` of ``fd`` in ``big_endian_dtype``.

    Returns bytes written; raises OSError on failure. Falls back to numpy
    conversion + os.pwrite when the native library is unavailable.
    """
    want = np.dtype(big_endian_dtype)
    src = np.ascontiguousarray(arr, dtype=want.newbyteorder("="))
    l = lib()
    if l is None:
        payload = src.astype(want).tobytes()
        os.pwrite(fd, payload, offset)
        return len(payload)
    n = int(src.size)
    written = l.pace_swap_write(
        fd, offset, src.ctypes.data, n, want.itemsize,
        1 if _needs_swap(want) else 0,
    )
    if written < 0:
        raise OSError(f"pace_swap_write failed (fd={fd}, offset={offset})")
    return int(written)


def swap_read(fd: int, offset: int, count: int, big_endian_dtype) -> np.ndarray:
    """Read ``count`` elements of ``big_endian_dtype`` at ``offset``; return
    a native-endian array."""
    want = np.dtype(big_endian_dtype)
    out = np.empty(count, dtype=want.newbyteorder("="))
    l = lib()
    if l is None:
        raw = os.pread(fd, count * want.itemsize, offset)
        if len(raw) != count * want.itemsize:
            raise OSError("short read")
        out[...] = np.frombuffer(raw, dtype=want)
        return out
    got = l.pace_swap_read(
        fd, offset, out.ctypes.data, count, want.itemsize,
        1 if _needs_swap(want) else 0,
    )
    if got < 0:
        raise OSError(f"pace_swap_read failed (fd={fd}, offset={offset})")
    return out
