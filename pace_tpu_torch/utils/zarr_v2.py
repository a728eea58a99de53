"""Minimal Zarr v2 directory-store writer (no zarr dependency).

Port of ``pace_tpu.utils.zarr_v2``, the diagnostics monitor's ``zarr`` store:
the v2 on-disk format is JSON metadata and raw chunk files, written here
directly (uncompressed C-order chunks, one chunk per time index, resizable
along axis 0), byte for byte as ``pace_tpu`` writes them. Output is readable
by any standard zarr v2 reader.
"""

from __future__ import annotations

import json
import os

import numpy as np


class ZarrGroup:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, ".zgroup"), "w") as f:
            json.dump({"zarr_format": 2}, f)
        self._shapes = {}

    def _array_dir(self, name: str) -> str:
        return os.path.join(self.path, name)

    def _write_zarray(self, name: str, shape, chunks, dtype: str):
        meta = {
            "zarr_format": 2,
            "shape": list(shape),
            "chunks": list(chunks),
            "dtype": dtype,
            "compressor": None,
            "fill_value": 0,
            "filters": None,
            "order": "C",
        }
        with open(os.path.join(self._array_dir(name), ".zarray"), "w") as f:
            json.dump(meta, f)
        self._shapes[name] = (tuple(shape), tuple(chunks), dtype)

    def write_constant(self, name: str, arr: np.ndarray):
        """Whole-array dataset in a single chunk."""
        arr = np.ascontiguousarray(arr, dtype=np.float32)
        d = self._array_dir(name)
        os.makedirs(d, exist_ok=True)
        self._write_zarray(name, arr.shape, arr.shape, "<f4")
        fname = ".".join(["0"] * max(arr.ndim, 1))
        with open(os.path.join(d, fname), "wb") as f:
            f.write(arr.tobytes())

    def append_time(self, name: str, it: int, arr: np.ndarray):
        """Write time index ``it`` of a (time, ...) dataset; one chunk per
        time index."""
        arr = np.ascontiguousarray(arr, dtype=np.float32)
        d = self._array_dir(name)
        if name not in self._shapes:
            os.makedirs(d, exist_ok=True)
            self._write_zarray(
                name, (it + 1,) + arr.shape, (1,) + arr.shape, "<f4"
            )
        else:
            shape, chunks, dtype = self._shapes[name]
            if it + 1 > shape[0]:
                self._write_zarray(name, (it + 1,) + arr.shape, chunks, dtype)
        fname = ".".join([str(it)] + ["0"] * arr.ndim)
        with open(os.path.join(d, fname), "wb") as f:
            f.write(arr.tobytes())


def read_array(path: str) -> np.ndarray:
    """Read back an uncompressed zarr v2 array (for tests/round-trips)."""
    meta = json.load(open(os.path.join(path, ".zarray")))
    if meta["compressor"] is not None or meta["filters"]:
        raise NotImplementedError("only uncompressed arrays supported")
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    dtype = np.dtype(meta["dtype"])
    out = np.full(shape, meta["fill_value"], dtype=dtype)
    grid = [
        range((s + c - 1) // c) for s, c in zip(shape, chunks)
    ] or [range(1)]
    import itertools

    for idx in itertools.product(*grid):
        fname = ".".join(str(i) for i in idx) if shape else "0"
        fpath = os.path.join(path, fname)
        if not os.path.exists(fpath):
            continue
        chunk = np.frombuffer(open(fpath, "rb").read(), dtype=dtype).reshape(
            chunks
        )
        sel = tuple(
            slice(i * c, min((i + 1) * c, s))
            for i, c, s in zip(idx, chunks, shape)
        )
        trim = tuple(slice(0, sl.stop - sl.start) for sl in sel)
        out[sel] = chunk[trim]
    return out
