"""Filesystem abstraction for local and remote (object-store) paths.

Port of ``pace_tpu.utils.filesystem`` (reference role: ``ndsl.filesystem``,
``fs = filesystem.get_fs(path); fs.makedirs(path, exist_ok=True)``). Backed
by fsspec when it is installed, so that restart and diagnostics paths may be
``gs://`` or ``s3://`` URLs; without it, a minimal local-only shim with the
same duck-typed surface.
"""

from __future__ import annotations

import glob as _glob
import os
import shutil
from typing import Any, List

try:  # fsspec is optional; everything local works without it
    import fsspec as _fsspec
except Exception:  # pragma: no cover - exercised only in stripped envs
    _fsspec = None


class _LocalFS:
    """Duck-typed subset of fsspec.AbstractFileSystem used by the driver."""

    def makedirs(self, path: str, exist_ok: bool = False) -> None:
        os.makedirs(path, exist_ok=exist_ok)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def isdir(self, path: str) -> bool:
        return os.path.isdir(path)

    def open(self, path: str, mode: str = "rb"):
        return open(path, mode)

    def ls(self, path: str) -> List[str]:
        return sorted(os.path.join(path, p) for p in os.listdir(path))

    def glob(self, pattern: str) -> List[str]:
        return sorted(_glob.glob(pattern))

    def rm(self, path: str, recursive: bool = False) -> None:
        if os.path.isdir(path):
            if not recursive:
                raise IsADirectoryError(path)
            shutil.rmtree(path)
        else:
            os.remove(path)

    def get(self, rpath: str, lpath: str, recursive: bool = False) -> None:
        if os.path.isdir(rpath):
            shutil.copytree(rpath, lpath, dirs_exist_ok=True)
        else:
            shutil.copy(rpath, lpath)


_LOCAL = _LocalFS()


def get_fs(path: str) -> Any:
    """Return a filesystem object for *path* (reference role: ndsl.filesystem.get_fs).

    Remote URL schemes (``gs://``, ``s3://``, …) require fsspec; plain local
    paths work with or without it.
    """
    if _fsspec is not None:
        fs, _ = _fsspec.core.url_to_fs(path)
        return fs
    if "://" in path and not path.startswith("file://"):
        raise RuntimeError(
            f"remote path {path!r} requires fsspec, which is not installed"
        )
    return _LOCAL


def is_file(path: str) -> bool:
    return get_fs(path).exists(path)


def open_file(path: str, mode: str = "rb"):
    """Open *path* on whatever filesystem it lives on."""
    if _fsspec is not None:
        return _fsspec.open(path, mode).open()
    return _LOCAL.open(path, mode)
