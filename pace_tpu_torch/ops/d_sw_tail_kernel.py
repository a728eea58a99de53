"""The fused D-grid tail CUDA kernel's wrapper.

Kernel source: ``csrc/d_sw_tail.cu`` (replaces
``pace_tpu/ops/d_sw_tail_pallas.py`` ``_kernel``). :func:`d_sw_tail_cuda`
takes the fields of ``ops.d_sw.d_sw_tail_plain`` on the card and returns its
``(u_new, v_new, heat)``; it counts its launches in :data:`LAUNCHES`.
``ops.d_sw.d_sw_tail`` picks one of the two by where its operands lie
(ops/_dispatch.py).

The kernel clamps its cell-to-interface reads exactly as the plain version's
edge-replicating pads do, so the two agree on the whole plane. The
configuration reaches it as numbers: ``nord`` (0 to 3), whether the
Smagorinsky part (``dddmp > 0``), the tile-edge band, the vorticity damping
fluxes and the heat estimate are on, and the per-level ``d2_col``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ._dispatch import check_operands
from .c_sw_tail_kernel import _device_corner_arrays
from .d_sw import DSWConfig, damping_column, tracks_heat
from .delnflux import lap_corner_weights

#: launches since the count was last reset
LAUNCHES = {"d_sw_tail": 0}

_FN = {torch.float32: "pace_d_sw_tail_f32", torch.float64: "pace_d_sw_tail_f64"}

#: largest divergence-damping order the kernel's staged ring holds
MAX_NORD = 3

FIELDS = ("u", "v", "ut", "vt", "divg_d", "vort", "vfx", "vfy", "dvfx", "dvfy")
#: constant planes in the kernel's argument order; ``wgx``/``wgy`` come from
#: ``delnflux.lap_corner_weights``, the four ``edge_*`` vectors follow
CONSTS = ("dx", "rdx", "dy", "rdy", "rsin2", "cosa_s", "f0", "wgx", "wgy", "rarea_c")
EDGES = ("edge_s_iface", "edge_n_iface", "edge_w_iface", "edge_e_iface")

_CELL, _XI, _YI, _CORNER = (0, 0), (0, 1), (1, 0), (1, 1)
_FIELD_STAGGER = dict(u=_YI, v=_XI, ut=_XI, vt=_YI, divg_d=_CORNER, vort=_CELL,
                      vfx=_XI, vfy=_YI, dvfx=_XI, dvfy=_YI)
_CONST_STAGGER = dict(dx=_YI, rdx=_YI, dy=_XI, rdy=_XI, rsin2=_CELL, cosa_s=_CELL,
                      f0=_CELL, wgx=_YI, wgy=_XI, rarea_c=_CORNER)


def _fn(dtype):
    return set_argtypes(getattr(_build.library("d_sw_tail"), _FN[dtype]))


def tail_params(config: DSWConfig, dt: float, da_min_c: float):
    """The kernel's five numbers ``(dt, dddmp, da_min_c, dampn, dmin_edge)``:
    ``dampn`` is the signed high-order coefficient ``d4_bg^(nord+1) da_min_c
    (-1)^nord`` and ``dmin_edge`` the band's ``da_min_c max(d4_bg / 3,
    d2_bg)``, both formed in double precision as the plain version's Python
    arithmetic forms them."""
    dampn = config.d4_bg ** (config.nord + 1) * da_min_c * ((-1.0) ** config.nord)
    dmin_edge = da_min_c * max(config.d4_bg / 3.0, config.d2_bg)
    return (float(dt), float(config.dddmp), float(da_min_c), dampn, dmin_edge)


@functools.lru_cache(maxsize=8)
def _device_d2_col(config: DSWConfig, K: int, dtype, device: str):
    return torch.tensor(damping_column(config, K), dtype=dtype, device=device)


def d_sw_tail_cuda(u, v, ut, vt, divg_d, vort, vfx, vfy, dvfx, dvfy,
                   grid, dt: float, config: DSWConfig):
    """Fused-kernel ``(u_new, v_new, heat)`` of 4-D CUDA fields; ``dvfx``,
    ``dvfy`` may both be ``None``, and ``heat`` is ``None`` when the
    configuration tracks none."""
    if vort.ndim != 4:
        raise ValueError(f"d_sw tail kernel takes (S, K, Y, X) fields, got {tuple(vort.shape)}")
    if not 0 <= config.nord <= MAX_NORD:
        raise ValueError(f"d_sw tail kernel takes nord 0..{MAX_NORD}, got {config.nord}")
    if (dvfx is None) != (dvfy is None):
        raise ValueError("d_sw tail kernel: dvfx and dvfy come together")
    S, K, Y, X = vort.shape
    fields = (u, v, ut, vt, divg_d, vort, vfx, vfy, dvfx, dvfy)
    named = [(n, t, (S, K, Y + _FIELD_STAGGER[n][0], X + _FIELD_STAGGER[n][1]))
             for n, t in zip(FIELDS, fields) if t is not None]
    named += [(n, t, (S, Y + dy, X + dx))
              for (n, (dy, dx)), t in zip(_CONST_STAGGER.items(), _constants(grid, config))]
    named += [(n, getattr(grid, n), (S, Y + 1, 1) if i < 2 else (S, 1, X + 1))
              for i, n in enumerate(EDGES)]
    check_operands("d_sw tail kernel", named, vort)
    out = call(_fn(vort.dtype), fields, grid, dt, config, _build.stream_handle(vort.device))
    LAUNCHES["d_sw_tail"] += 1
    return out


def _constants(grid, config: DSWConfig):
    """The constant planes in the order of :data:`CONSTS`."""
    wgx, wgy = lap_corner_weights(grid, config.lap_divg_weights)
    return [wgx if n == "wgx" else wgy if n == "wgy" else getattr(grid, n) for n in CONSTS]


def call(fn, fields, grid, dt: float, config: DSWConfig, stream=None):
    """Call the C entry ``fn`` (``pace_d_sw_tail_f32`` / ``_f64`` of a
    library built from ``csrc/d_sw_tail.cu``) on ``fields``, the ten
    tensors of :data:`FIELDS` (the last two may be ``None``), wherever they
    lie; checks nothing (:func:`d_sw_tail_cuda` checks first). Returns
    ``(u_new, v_new, heat)``."""
    u, v, vort = fields[0], fields[1], fields[5]
    S, K, Y, X = vort.shape
    d2_col = _device_d2_col(config, K, vort.dtype, str(vort.device))
    u_new, v_new = torch.empty_like(u), torch.empty_like(v)
    heat = torch.empty_like(vort) if tracks_heat(config) else None
    table = tuple(grid.corner_table)
    pos, quad, own = _device_corner_arrays(table, S, str(vort.device))
    order = (list(fields) + _constants(grid, config) + [getattr(grid, n) for n in EDGES]
             + [d2_col, u_new, v_new, heat])
    ptrs = (ctypes.c_void_p * len(order))(*(None if t is None else t.data_ptr() for t in order))
    prm = (ctypes.c_double * 5)(*tail_params(config, dt, grid.da_min_c))
    rc = fn(ptrs, prm, int(config.nord), int(config.dddmp > 0.0), int(config.edge_damp_band),
            pos.data_ptr(), quad.data_ptr(), own.data_ptr(), len(table), S, K, Y, X, stream)
    _build.check(rc, "d_sw tail kernel")
    return u_new, v_new, heat


def set_argtypes(fn):
    """Declare the C entry's argument types on ``fn``; returns it."""
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, I, I, I, P, P, P, I, I, I, I, I, P]
        fn.restype = I
    return fn
