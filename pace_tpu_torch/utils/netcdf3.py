"""Self-contained NetCDF-3 (classic CDF-1 / 64-bit-offset CDF-2) reader/writer.

Port of ``pace_tpu.utils.netcdf3``, numpy in, numpy out, no dependencies: the
classic format written directly from the NetCDF specification, for the
diagnostics monitor's ``netcdf`` store and ``DycoreState.to_netcdf``. The
port writes the same bytes as ``pace_tpu`` for the same variables, with the
native IO core (:mod:`.native`) and without it, and each package reads the
other's files.

Byte order is big-endian throughout. Record (unlimited-dimension) variables
are supported for both read and write.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import native

NC_BYTE = 1
NC_CHAR = 2
NC_SHORT = 3
NC_INT = 4
NC_FLOAT = 5
NC_DOUBLE = 6

_DTYPES = {
    NC_BYTE: np.dtype(">i1"),
    NC_CHAR: np.dtype("S1"),
    NC_SHORT: np.dtype(">i2"),
    NC_INT: np.dtype(">i4"),
    NC_FLOAT: np.dtype(">f4"),
    NC_DOUBLE: np.dtype(">f8"),
}
_NC_TYPE_OF = {
    "int8": NC_BYTE,
    "S1": NC_CHAR,
    "int16": NC_SHORT,
    "int32": NC_INT,
    "int64": NC_INT,  # classic netCDF has no 64-bit int; downcast
    "float32": NC_FLOAT,
    "float64": NC_DOUBLE,
}

_ABSENT = b"\x00\x00\x00\x00\x00\x00\x00\x00"
_NC_DIMENSION = 0x0A
_NC_VARIABLE = 0x0B
_NC_ATTRIBUTE = 0x0C


@dataclasses.dataclass
class Variable:
    dims: Tuple[str, ...]
    data: np.ndarray
    attrs: Dict[str, object] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class NetCDF3File:
    dims: Dict[str, Optional[int]]  # None length = unlimited
    variables: Dict[str, Variable]
    attrs: Dict[str, object]
    numrecs: int = 0


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------
class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def read(self, n: int) -> bytes:
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def i4(self) -> int:
        return struct.unpack(">i", self.read(4))[0]

    def i8(self) -> int:
        return struct.unpack(">q", self.read(8))[0]

    def name(self) -> str:
        n = self.i4()
        raw = self.read(n)
        self.read((4 - n % 4) % 4)
        return raw.decode("utf-8", errors="replace")

    def values(self, nc_type: int, n: int):
        dt = _DTYPES[nc_type]
        nbytes = dt.itemsize * n
        raw = self.read(nbytes)
        self.read((4 - nbytes % 4) % 4)
        if nc_type == NC_CHAR:
            return raw.decode("utf-8", errors="replace")
        arr = np.frombuffer(raw, dtype=dt)
        return arr if n > 1 else arr[0]

    def att_list(self) -> Dict[str, object]:
        tag = self.i4()
        n = self.i4()
        if tag == 0:
            return {}
        assert tag == _NC_ATTRIBUTE
        out = {}
        for _ in range(n):
            nm = self.name()
            t = self.i4()
            cnt = self.i4()
            out[nm] = self.values(t, cnt)
        return out


def read(path: str) -> NetCDF3File:
    """Read an entire NetCDF-3 file into memory."""
    buf = open(path, "rb").read()
    r = _Reader(buf)
    magic = r.read(4)
    if magic[:3] != b"CDF" or magic[3] not in (1, 2):
        raise ValueError(f"{path}: not a NetCDF classic file (magic {magic!r})")
    version = magic[3]
    numrecs = r.i4()
    if numrecs == -1:
        numrecs = 0  # STREAMING; computed below from file size

    # dimensions
    tag = r.i4()
    ndims = r.i4()
    dim_names: List[str] = []
    dim_sizes: List[int] = []
    unlimited = None
    if tag != 0:
        assert tag == _NC_DIMENSION
        for i in range(ndims):
            nm = r.name()
            sz = r.i4()
            dim_names.append(nm)
            dim_sizes.append(sz)
            if sz == 0:
                unlimited = i

    gatts = r.att_list()

    tag = r.i4()
    nvars = r.i4()
    var_meta = []
    if tag != 0:
        assert tag == _NC_VARIABLE
        for _ in range(nvars):
            nm = r.name()
            nd = r.i4()
            dimids = [r.i4() for _ in range(nd)]
            vatts = r.att_list()
            t = r.i4()
            vsize = r.i4()
            begin = r.i8() if version == 2 else r.i4()
            var_meta.append((nm, dimids, vatts, t, vsize, begin))

    # record stride: sum of record-var vsizes (already padded); the special
    # one-record-var case packs without padding but vsize still reports padded
    rec_vars = [m for m in var_meta if m[1] and m[1][0] == unlimited]
    variables: Dict[str, Variable] = {}
    for nm, dimids, vatts, t, vsize, begin in var_meta:
        dt = _DTYPES[t]
        dims = tuple(dim_names[i] for i in dimids)
        shape = [dim_sizes[i] for i in dimids]
        is_rec = bool(dimids) and dimids[0] == unlimited
        if not is_rec:
            count = int(np.prod(shape)) if shape else 1
            arr = np.frombuffer(
                buf, dtype=dt, count=count, offset=begin
            ).reshape(shape)
        else:
            rec_shape = shape[1:]
            per_rec = int(np.prod(rec_shape)) if rec_shape else 1
            if len(rec_vars) == 1:
                stride = per_rec * dt.itemsize
            else:
                stride = sum(m[4] for m in rec_vars)
            if numrecs == 0 and stride > 0:
                numrecs = (len(buf) - begin) // stride
            recs = []
            for rec in range(numrecs):
                recs.append(
                    np.frombuffer(
                        buf,
                        dtype=dt,
                        count=per_rec,
                        offset=begin + rec * stride,
                    ).reshape(rec_shape)
                )
            arr = (
                np.stack(recs)
                if recs
                else np.zeros([0] + rec_shape, dtype=dt)
            )
        if arr.nbytes >= (1 << 20):
            # large payloads: parallel native-endian conversion up front
            # (the lazy big-endian view would convert single-threaded on use)
            arr = native.to_native_endian(arr)
        variables[nm] = Variable(dims=dims, data=arr, attrs=vatts)

    dims_out: Dict[str, Optional[int]] = {}
    for i, (nm, sz) in enumerate(zip(dim_names, dim_sizes)):
        dims_out[nm] = None if i == unlimited else sz
    return NetCDF3File(
        dims=dims_out, variables=variables, attrs=gatts, numrecs=numrecs
    )


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------
def _pad4(b: bytes) -> bytes:
    return b + b"\x00" * ((4 - len(b) % 4) % 4)


def _enc_name(nm: str) -> bytes:
    raw = nm.encode("utf-8")
    return struct.pack(">i", len(raw)) + _pad4(raw)


def _enc_values(val) -> Tuple[int, int, bytes]:
    """Return (nc_type, nelems, payload) for an attribute value."""
    if isinstance(val, str):
        raw = val.encode("utf-8")
        return NC_CHAR, len(raw), _pad4(raw)
    if isinstance(val, bytes):
        return NC_CHAR, len(val), _pad4(val)
    arr = np.atleast_1d(np.asarray(val))
    t = _NC_TYPE_OF[arr.dtype.name]
    be = arr.astype(_DTYPES[t])
    return t, arr.size, _pad4(be.tobytes())


def _enc_atts(attrs: Dict[str, object]) -> bytes:
    if not attrs:
        return _ABSENT
    out = struct.pack(">ii", _NC_ATTRIBUTE, len(attrs))
    for nm, val in attrs.items():
        t, n, payload = _enc_values(val)
        out += _enc_name(nm) + struct.pack(">ii", t, n) + payload
    return out


def write(path: str, f: NetCDF3File, version: int = 2) -> None:
    """Write a NetCDF-3 file (CDF-2 / 64-bit offset by default)."""
    dim_names = list(f.dims.keys())
    unlimited = None
    for i, nm in enumerate(dim_names):
        if f.dims[nm] is None:
            unlimited = i

    numrecs = 0
    for v in f.variables.values():
        if v.dims and unlimited is not None and v.dims[0] == dim_names[unlimited]:
            numrecs = max(numrecs, v.data.shape[0])

    header = b"CDF" + bytes([version])
    header += struct.pack(">i", numrecs)
    if dim_names:
        header += struct.pack(">ii", _NC_DIMENSION, len(dim_names))
        for i, nm in enumerate(dim_names):
            sz = 0 if i == unlimited else int(f.dims[nm])
            header += _enc_name(nm) + struct.pack(">i", sz)
    else:
        header += _ABSENT
    header += _enc_atts(f.attrs)

    # variable entries: compute sizes, lay out fixed vars then record vars
    entries = []
    for nm, v in f.variables.items():
        arr = np.asarray(v.data)
        t = _NC_TYPE_OF[arr.dtype.name]
        dimids = [dim_names.index(d) for d in v.dims]
        is_rec = bool(dimids) and dimids and dimids[0] == unlimited
        per = arr[0] if (is_rec and arr.shape[0] > 0) else arr
        if is_rec:
            shape = arr.shape[1:]
        else:
            shape = arr.shape
        nbytes = int(np.prod(shape)) * _DTYPES[t].itemsize if shape else _DTYPES[t].itemsize
        vsize = nbytes + ((4 - nbytes % 4) % 4)
        entries.append([nm, v, t, dimids, is_rec, vsize, 0])
    del per

    # header size estimate: assemble var table with placeholder begins, then
    # recompute begins and re-assemble (two passes; begin width fixed by ver)
    def var_table(entries) -> bytes:
        if not entries:
            return _ABSENT
        out = struct.pack(">ii", _NC_VARIABLE, len(entries))
        for nm, v, t, dimids, is_rec, vsize, begin in entries:
            out += _enc_name(nm)
            out += struct.pack(">i", len(dimids))
            for d in dimids:
                out += struct.pack(">i", d)
            out += _enc_atts(v.attrs)
            out += struct.pack(">ii", t, vsize)
            out += struct.pack(">q" if version == 2 else ">i", begin)
        return out

    base = len(header) + len(var_table(entries))
    offset = base
    for e in entries:
        if not e[4]:  # fixed
            e[6] = offset
            offset += e[5]
    rec_entries = [e for e in entries if e[4]]
    rec_begin = offset
    for e in rec_entries:
        e[6] = offset
        offset += e[5]
    rec_stride = sum(e[5] for e in rec_entries)
    if len(rec_entries) == 1:
        # single record variable: packed without per-record padding
        e = rec_entries[0]
        nbytes_per_rec = e[5]
        arr = np.asarray(e[1].data)
        per = int(np.prod(arr.shape[1:])) if arr.ndim > 1 else 1
        rec_stride = per * _DTYPES[e[2]].itemsize

    # payloads go through the native IO core (utils/native.py:
    # multithreaded endian swap + pwrite; silent numpy fallback) — gaps left
    # between pwrites are the zero padding NetCDF requires, materialized by
    # the final ftruncate
    end_of_file = offset if not rec_entries else rec_begin + numrecs * rec_stride
    end_of_file = max(end_of_file, base)
    with open(path, "wb") as fh:
        fh.write(header)
        fh.write(var_table(entries))
        fh.flush()
        fd = fh.fileno()
        for nm, v, t, dimids, is_rec, vsize, begin in entries:
            if is_rec:
                continue
            native.swap_write(fd, begin, np.asarray(v.data), _DTYPES[t])
        for nm, v, t, dimids, is_rec, vsize, begin in entries:
            if not is_rec:
                continue
            arr = np.asarray(v.data)
            for rec in range(min(numrecs, arr.shape[0] if arr.ndim else 0)):
                native.swap_write(
                    fd, begin + rec * rec_stride, arr[rec], _DTYPES[t]
                )
        if os.fstat(fd).st_size < end_of_file:
            os.ftruncate(fd, end_of_file)


def write_simple(path: str, arrays: Dict[str, np.ndarray],
                 attrs: Optional[Dict[str, object]] = None) -> None:
    """Convenience: write named arrays with auto-named dimensions."""
    dims: Dict[str, Optional[int]] = {}
    variables: Dict[str, Variable] = {}
    for nm, arr in arrays.items():
        arr = np.asarray(arr)
        dnames = []
        for ax, sz in enumerate(arr.shape):
            dn = f"{nm}_d{ax}"
            dims[dn] = int(sz)
            dnames.append(dn)
        variables[nm] = Variable(dims=tuple(dnames), data=arr)
    write(path, NetCDF3File(dims=dims, variables=variables, attrs=attrs or {}))
