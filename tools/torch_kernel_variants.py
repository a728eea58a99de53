#!/usr/bin/env python3
"""Time the tuning candidates of the sim1, multi-field transport,
tracer-block transport, single-field transport, D-grid tail, C-grid tail,
d2a2c, hydrostatic-chain and updatedz_c kernels on one NVIDIA card, at the
dycore step's shapes.

Each candidate is the current source (``pace_tpu_torch/csrc/sim1.cu``,
``fvtp2d.cu``, ``d_sw_tail.cu``, ``c_sw_tail.cu``, ``d2a2c.cu``,
``hydro.cu`` or ``updatedz.cu``) with one or more of its
tuning constants changed (``CANDIDATES`` below: tile width and blocks an SM
for sim1; segment lengths, blocks an SM, the tile and, for the single-field
kernel, levels a block, level buffers or the tracer kernel in its place for
the transports; tile shape, levels a block, threads and blocks an SM for the
tails; tile, levels a block and levels a step for d2a2c; threads a block,
levels a copy, registers and unrolling for hydro; threads a block, levels a
thread, registers and unrolling for updatedz_c), built with ``_build.NVCC_FLAGS`` into ``build/kernels/variants``
(gitignored), and run through the current wrapper on the inputs of
``tools/torch_kernel_ab.py`` (C192 npz=79 f32: sim1 on one nonhydrostatic
C-grid half step's operands, the multi-field transport on d_sw's pt /
vorticity / w, the tracer block on chip_smoke.py's nine tracers, the
single-field transport on the substep's delp call (corner pack, K = 79) and
heights call (full qy, K = 80), the D-grid tail on the benchmark's nord 3
case, the C-grid tail on one C-grid half step's operands, d2a2c on the
exchanged winds of the baroclinic-wave state, hydro on one C-grid tail's
delpc and ptc in each form a step launches, updatedz_c on one
nonhydrostatic C-grid half step's heights and area fluxes). Two rounds of
CUDA-event means of 20 launches (the tracer block 5), the current build first
in each, and whether each candidate gives the current build's bits. Run from
the repository root on a machine with a card and ``nvcc``::

    python3 tools/torch_kernel_variants.py [--kernels sim1,fvtp2d,tracer,single,d_sw_tail,c_sw_tail,d2a2c,hydro,updatedz_c] [--prev DIR]

Prints ``[build]`` lines (registers and spills), ``[variant]`` lines and the
card's name and power limit. ``DIAGNOSTICS`` adds builds that leave a part of
a kernel out, to time the rest (their bits differ). With ``--prev DIR`` (a
directory of earlier sources, as for ``tools/torch_kernel_ab.py``), the
earlier source of each picked kernel that ``EARLIER`` lists is built as it
is and with each of its diagnostics, and timed in the same rounds. A
candidate whose text is not in the source raises: the tables follow the
source.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tools"))

import chip_smoke  # noqa: E402
import torch_kernel_ab as ab  # noqa: E402
from pace_tpu_torch import _build  # noqa: E402

log = chip_smoke.log

_SIM1_THREADS = "constexpr int kThreads = 256;"
_SIM1_BLOCKS = "constexpr int kBlocksPerSM = 4;"
_SIM1_SMEM = "constexpr long long kSmemPerBlock = 57344;"
_SEG_IN = "constexpr int kSegIn = 3;"
_SEG_OUT = "constexpr int kSegOut = 2;"
_MULTI_BLOCKS = "return sizeof(T) == 8 ? 2 : 4;"
_TRACER_SEG_IN = "constexpr int kSegInTracer = 3;"
_TRACER_TILE = "using TracerTile = Tile<20, 40, 47>;"
_TRACER_BLOCKS = "constexpr int tracer_blocks() {\n  return sizeof(T) == 8 ? 2 : 4;"
_TRACER_SEG_OUT = "constexpr int kSegOutTracer = 4;"
_TAIL_TY = "constexpr int TY = 8;       // slot rows of a tile"
_TAIL_TX = "constexpr int TX = 40;      // slot columns of a tile"
_TAIL_LEVELS = "constexpr int kLevels = 8;  // levels a block walks"
_TAIL_BLOCKS = "return sizeof(T) == 8 ? 2 : 4;"
_TAIL_THREADS = "constexpr int kThreads = 256;  // threads a block"
_SINGLE_TILE = "using SingleTile = Tile<20, 40, 47>;"
_SINGLE_BLOCKS = "constexpr int single_blocks() {\n  return sizeof(T) == 8 ? 2 : 4;"
_SINGLE_SEG_IN = "constexpr int kSegInSingle = 3;"
_SINGLE_SEG_OUT = "constexpr int kSegOutSingle = 4;"
_CSW_TILE = "constexpr int TY = 16;\nconstexpr int TX = 40;"
_CSW_THREADS = "constexpr int kThreads = 384;\n"
_CSW_BOUNDS = "__launch_bounds__(kThreads) c_sw_tail_kernel"
_D2A2C_TILE = "constexpr int TY = 12;\nconstexpr int TX = 40;\n"
_D2A2C_THREADS = "constexpr int kThreads = 704;  // >= VY * VX"
_D2A2C_LEVELS = "constexpr int kLevels = 28;    // levels walked by one block"
_D2A2C_STEP = "return sizeof(T) == 8 ? 1 : 2;"
_HYDRO_THREADS = "constexpr int kThreads = 128;"
_HYDRO_CHUNK = "constexpr int kChunk = 4;"
_HYDRO_BLOCKS = "return sizeof(T) == 8 ? 8 : 16;"
_HYDRO_UNROLL = "#pragma unroll 2\n    for (int j = 0; j < n; ++j) {"
_HYDRO_LOG = "float vlog<float>(float x) { return logf(x); }"
_HYDRO_POW = "float vpow<float>(float x, float y) { return powf(x, y); }"
_UZ_THREADS = "constexpr int kUzThreads = 256;"
_UZ_LEVELS = "constexpr int kUzLevels = 80;"
_UZ_BLOCKS = "static constexpr int blocks = sizeof(T) == 8 ? 4 : 8;"
_UZ_UNROLL = "static constexpr int unroll = sizeof(T) == 8 ? 1 : 2;"
_UZ_MATH = ("  const T zw = xw > T(0) ? zwl : zc;\n  const T ze = xe > T(0) ? zc : zer;\n"
            "  const T zs = ys > T(0) ? ysl : yc;\n  const T zn = yn > T(0) ? yc : ynr;\n"
            "  const T ra = (a + (xw - xe)) + (ys - yn);\n"
            "  return ((zc * a + (zw * xw - ze * xe)) + (zs * ys - zn * yn)) / ra;")
_UZ_HEIGHTS = ("  zc = zx[o];\n  const T zwl = zx[o - dw], zer = zx[o + de];\n"
               "  const T yc = zy[o], ysl = zy[o - ds], ynr = zy[o + dn];")
_UZ_FLUXES = "    const T qw = fw[j * Px], qe = fw[j * Px + 1], qs = fs[j * Py], qn = fs[j * Py + X];"
#: the flux loads of a level replaced by arithmetic on the carried fluxes
_UZ_FLUXES_MATH = ("    const T qw = pw * T(1.5) - a, qe = pe * T(0.5) + a, qs = ps - T(j), "
                   "qn = pn + T(j);")
_HYDRO_DIVS = [("pe / p_ref, kappa);\n      const long long o", "pe * p_ref, kappa);\n      const long long o"),
               ("= (pk_n - pk) / (kappa", "= (pk_n - pk) * (kappa")]


def _sim1(blocks, smem, threads=256):
    return [(_SIM1_BLOCKS, f"constexpr int kBlocksPerSM = {blocks};"),
            (_SIM1_SMEM, f"constexpr long long kSmemPerBlock = {smem};"),
            (_SIM1_THREADS, f"constexpr int kThreads = {threads};")]


def _multi(seg_in, seg_out, blocks):
    return [(_SEG_IN, f"constexpr int kSegIn = {seg_in};"),
            (_SEG_OUT, f"constexpr int kSegOut = {seg_out};"),
            (_MULTI_BLOCKS, f"return sizeof(T) == 8 ? 2 : {blocks};")]


def _tracer_segments(seg_in, seg_out):
    return [(_TRACER_SEG_IN, f"constexpr int kSegInTracer = {seg_in};"),
            (_TRACER_SEG_OUT, f"constexpr int kSegOutTracer = {seg_out};")]


def _tracer_tile(ty, tx, ld, blocks):
    return [(_TRACER_TILE, f"using TracerTile = Tile<{ty}, {tx}, {ld}>;"),
            (_TRACER_BLOCKS, _TRACER_BLOCKS.replace(": 4;", f": {blocks};"))]


def _single(ty=20, tx=40, ld=47, blocks=4):
    return [(_SINGLE_TILE, f"using SingleTile = Tile<{ty}, {tx}, {ld}>;"),
            (_SINGLE_BLOCKS, _SINGLE_BLOCKS.replace(": 4;", f": {blocks};"))]


def _single_segments(seg_in, seg_out):
    return [(_SINGLE_SEG_IN, f"constexpr int kSegInSingle = {seg_in};"),
            (_SINGLE_SEG_OUT, f"constexpr int kSegOutSingle = {seg_out};")]


def _c_sw_tail(ty=16, tx=40, threads=384, blocks=None):
    subs = [(_CSW_TILE, f"constexpr int TY = {ty};\nconstexpr int TX = {tx};"),
            (_CSW_THREADS, f"constexpr int kThreads = {threads};\n")]
    if blocks:
        subs.append((_CSW_BOUNDS, f"__launch_bounds__(kThreads, {blocks}) c_sw_tail_kernel"))
    return subs


def _d2a2c(ty=12, tx=40, levels=28, step=2):
    threads = ((ty + 4) * (tx + 4) + 31) // 32 * 32
    return [(_D2A2C_TILE, f"constexpr int TY = {ty};\nconstexpr int TX = {tx};\n"),
            (_D2A2C_STEP, f"return sizeof(T) == 8 ? 1 : {step};"),
            (_D2A2C_THREADS, f"constexpr int kThreads = {threads};  // >= VY * VX"),
            (_D2A2C_LEVELS, f"constexpr int kLevels = {levels};    // levels walked by one block")]


def _hydro(threads=128, chunk=4, blocks=16):
    return [(_HYDRO_THREADS, f"constexpr int kThreads = {threads};"),
            (_HYDRO_CHUNK, f"constexpr int kChunk = {chunk};"),
            (_HYDRO_BLOCKS, f"return sizeof(T) == 8 ? 8 : {blocks};")]


def _updatedz_c(threads=256, levels=80, blocks=8, unroll=2, blocks64=4, unroll64=1):
    return [(_UZ_THREADS, f"constexpr int kUzThreads = {threads};"),
            (_UZ_LEVELS, f"constexpr int kUzLevels = {levels};"),
            (_UZ_BLOCKS, f"static constexpr int blocks = sizeof(T) == 8 ? {blocks64} : {blocks};"),
            (_UZ_UNROLL, f"static constexpr int unroll = sizeof(T) == 8 ? {unroll64} : {unroll};")]


def _tail(ty, tx, levels, blocks, threads=256):
    return [(_TAIL_TY, f"constexpr int TY = {ty};"), (_TAIL_TX, f"constexpr int TX = {tx};"),
            (_TAIL_LEVELS, f"constexpr int kLevels = {levels};"),
            (_TAIL_BLOCKS, f"return sizeof(T) == 8 ? 1 : {blocks};"),
            (_TAIL_THREADS, f"constexpr int kThreads = {threads};  // threads a block")]


_SIM1_CHAIN = "  if (tid < nc) {\n    T cp = T(0), dv = T(0), b_up = T(0);"
_FIELD_START = ("  const int X1 = X + 1;\n  const int tid = threadIdx.x;\n"
                "  static_assert(TX % SO == 0")
_STAGE_QX = "    cp_async(s_qx + m, src);"
_STAGE_QY = "    cp_async(s_qy + m, src);"
_STAGE_OPS = ("    cp_async(s_ops + m, crx_p + gj * X1 + gi);\n"
              "    cp_async(s_ops + 2 * NSM + m, xfx_p + gj * X1 + gi);\n"
              "    cp_async(s_ops + NSM + m, cry_p + gj * X + gi);\n"
              "    cp_async(s_ops + 3 * NSM + m, yfx_p + gj * X + gi);\n")
_TAIL_LEVEL = ("    if (k + 1 < k1) stage_level(k + 1, OFF_LEV + ((k + 1 - k0) & 1) * "
               "kLevelVals);\n")
_TAIL_COPY = ('  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\\n" ::"r"(d), "l"(src),\n'
              '               "n"(sizeof(T)));')
_FVTP2D_DIAGNOSTICS = {
    "diagnostic: loads and barriers alone": [
        (_FIELD_START, _FIELD_START.replace(
            "threadIdx.x;\n", "threadIdx.x;\n  if (tid == 0 && s_qx[0] == T(12345)) "
            "fx_p[0] = s_qy[1];\n  __syncthreads();\n  return;\n"))],
    "diagnostic: passes alone": [
        (_STAGE_QX, "    (void)src;"), (_STAGE_QY, "    (void)src;"),
        (_STAGE_OPS, "    (void)gj;\n")],
}

#: diagnostics that time a part of a kernel (their results are wrong): sim1
#: without its serial recurrence; the transport with its loads and barriers
#: alone (each field returns at once), and with its passes alone (no field
#: and of the operands only the areas loaded: the passes run on stale shared
#: memory)
DIAGNOSTICS = {
    "sim1": {
        "diagnostic: without the recurrence": [
            (_SIM1_CHAIN, _SIM1_CHAIN.replace("tid < nc", "tid < 0"))],
    },
    "fvtp2d": _FVTP2D_DIAGNOSTICS,
    "tracer": _FVTP2D_DIAGNOSTICS,
    "single": _FVTP2D_DIAGNOSTICS,
    # the tail: every level's loads and barrier without its passes; the
    # passes without any copy (on stale shared memory)
    "d_sw_tail": {
        "diagnostic: loads and barriers alone": [
            (_TAIL_LEVEL, _TAIL_LEVEL + "    if (k >= 0) continue;\n")],
        "diagnostic: passes alone": [(_TAIL_COPY, "  (void)d;\n  (void)src;")],
    },
    # the C-grid tail reads its operands straight from device memory in its
    # passes: nothing to separate
    "c_sw_tail": {},
    # d2a2c: every level's copies and first barrier without its three stages
    # d2a2c: the stages without the next level's loads (on stale shared
    # memory)
    "d2a2c": {
        "diagnostic: stages alone (no loads)": [
            ("    if (k + L < k_end) prefetch(k + L);\n", "")],
    },
    # hydro (float32): its loads and stores with log, pow and the two
    # divisions replaced by a multiplication or nothing, and each left out
    # alone
    "hydro": {
        "diagnostic: loads and stores alone": [
            (_HYDRO_LOG, "float vlog<float>(float x) { return x; }"),
            (_HYDRO_POW, "float vpow<float>(float x, float y) { return x * y; }"), *_HYDRO_DIVS],
        "diagnostic: without pow": [
            (_HYDRO_POW, "float vpow<float>(float x, float y) { return x * y; }")],
        "diagnostic: without log": [(_HYDRO_LOG, "float vlog<float>(float x) { return x; }")],
        "diagnostic: without the two divisions": _HYDRO_DIVS,
        "formula: pk = exp(kappa * (peln - log(p_ref)))": [
            ("      const T pk_n = vpow<T>(pe / p_ref, kappa);",
             "      const T pk_n = exp(kappa * (peln_n - log(p_ref)));")],
        "formula: pe times the reciprocal of p_ref": [
            ("      const T pk_n = vpow<T>(pe / p_ref, kappa);",
             "      const T pk_n = vpow<T>(pe * (T(1) / p_ref), kappa);")],
    },
    # updatedz_c: its loads and stores with nine additions in place of the
    # selects, the products and the division; its arithmetic and stores with
    # every height and (after the first) flux load replaced by arithmetic
    "updatedz_c": {
        "diagnostic: loads and stores alone": [
            (_UZ_MATH, "  return ((zc + zwl) + (zer + yc)) + ((ysl + ynr) + ((xw + xe) + (ys + yn)));")],
        "diagnostic: math alone (no loads)": [
            (_UZ_HEIGHTS, "  zc = a * T(o);\n  const T zwl = zc + T(dw), zer = zc - T(de);\n"
                          "  const T yc = zc * T(2), ysl = yc + T(ds), ynr = yc - T(dn);"),
            (_UZ_FLUXES, _UZ_FLUXES_MATH)],
    },
}

_UZ_EARLIER_MATH = ("    const T ra = (a + (xw - xe)) + (ys - yn);\n"
                    "    const T zh_new = ((zc * a + (zw * xw - ze * xe)) + (zs * ys - zn * yn)) / ra;")
_UZ_EARLIER_FLUXES = "      const T qw = fw[ox], qe = fw[ox + 1], qs = fs[oy], qn = fs[oy + X];"
_UZ_EARLIER_HEIGHTS = ("    const T zc = zx_p[o + c];\n    const T yc = zy_p[o + c];\n"
                       "    const T zw = xw > T(0) ? zx_p[o + cw] : zc;\n"
                       "    const T ze = xe > T(0) ? zc : zx_p[o + ce];\n"
                       "    const T zs = ys > T(0) ? zy_p[o + cs] : yc;\n"
                       "    const T zn = yn > T(0) ? yc : zy_p[o + cn];")

#: earlier sources timed beside the candidates with ``--prev``: name -> the
#: earlier design's own diagnostics (551ed44's updatedz_c: its loads, the
#: upwind heights still under the fluxes' signs, and stores with five
#: additions in place of the arithmetic; its arithmetic and stores with no
#: load after the first layer's fluxes)
EARLIER = {
    "updatedz_c": {
        "the earlier design": [],
        "the earlier design, diagnostic: loads and stores alone": [
            (_UZ_EARLIER_MATH, "    const T zh_new = ((zc + zw) + (ze + yc)) + (zs + zn);")],
        "the earlier design, diagnostic: math alone (no loads)": [
            (_UZ_EARLIER_FLUXES, "      const T qw = pw * T(1.5) - a, qe = pe * T(0.5) + a, "
                                 "qs = ps - T(j), qn = pn + T(j);\n      (void)ox;\n      (void)oy;"),
            (_UZ_EARLIER_HEIGHTS, "    const T zc = a * T(o + c);\n    const T yc = zc * T(2);\n"
                                  "    const T zw = xw > T(0) ? zc + T(cw) : zc;\n"
                                  "    const T ze = xe > T(0) ? zc : zc - T(ce);\n"
                                  "    const T zs = ys > T(0) ? yc + T(cs) : yc;\n"
                                  "    const T zn = yn > T(0) ? yc : yc - T(cn);")],
    },
}

#: name -> (source name, substitutions); the current source is "current":
#: sim1 16 columns a block at K = 79, four blocks an SM; the transport
#: segments of 3 and 2 interfaces, four blocks an SM
CANDIDATES = {
    "sim1": {
        "32 columns, 2 blocks an SM": _sim1(2, 115712),
        "16 columns, 5 blocks an SM": _sim1(5, 45670),
        "8 columns, 6 blocks an SM": _sim1(6, 37888),
        "16 columns, 192 threads, 5 blocks an SM": _sim1(5, 45670, 192),
        "16 columns, 128 threads, 5 blocks an SM": _sim1(5, 45670, 128),
    },
    "fvtp2d": {
        "segments 6 / 4, 4 blocks an SM": _multi(6, 4, 4),
        "segments 6 / 4, 3 blocks an SM": _multi(6, 4, 3),
        "segments 4 / 4, 4 blocks an SM": _multi(4, 4, 4),
        "segments 2 / 2, 4 blocks an SM": _multi(2, 2, 4),
        "segments 3 / 2, 3 blocks an SM": _multi(3, 2, 3),
        "segments 3 / 2, 5 blocks an SM": _multi(3, 2, 5),
        "segments 1 / 1, 6 blocks an SM": _multi(1, 1, 6),
    },
    "tracer": {
        "segments 3 / 2": _tracer_segments(3, 2),
        "segments 2 / 4": _tracer_segments(2, 4),
        "segments 4 / 4": _tracer_segments(4, 4),
        "segments 6 / 4": _tracer_segments(6, 4),
        "3 blocks an SM": _tracer_tile(20, 40, 47, 3),
        "segments 6 / 4, 3 blocks an SM": _tracer_segments(6, 4) + _tracer_tile(20, 40, 47, 3),
        "16 x 40 tiles": _tracer_tile(16, 40, 47, 4),
        "24 x 40 tiles, 3 blocks an SM": _tracer_tile(24, 40, 47, 3),
        "16 x 32 tiles (the multi-field kernel's)": _tracer_tile(16, 32, 41, 4),
    },
    "d_sw_tail": {
        "8 x 40 slots, 16 levels a block": _tail(8, 40, 16, 4),
        "8 x 40 slots, 4 levels a block": _tail(8, 40, 4, 4),
        "8 x 40 slots, 3 blocks an SM": _tail(8, 40, 8, 3),
        "12 x 40 slots, 3 blocks an SM": _tail(12, 40, 8, 3),
        "16 x 40 slots, 2 blocks an SM": _tail(16, 40, 8, 2),
        "16 x 32 slots, 3 blocks an SM": _tail(16, 32, 8, 3),
        "8 x 32 slots, 5 blocks an SM": _tail(8, 32, 8, 5),
        "8 x 40 slots, 384 threads, 2 blocks an SM": _tail(8, 40, 8, 2, 384),
        "8 x 40 slots, 320 threads, 3 blocks an SM": _tail(8, 40, 8, 3, 320),
        "6 x 40 slots, 4 blocks an SM": _tail(6, 40, 8, 4),
        "6 x 40 slots, 5 blocks an SM": _tail(6, 40, 8, 5),
        "10 x 40 slots, 3 blocks an SM": _tail(10, 40, 8, 3),
    },
    "single": {
        "(a) the tracer kernel at NQ = 1": [
            ("return launch_single_hord<T, ", "return launch_tracer_hord<T, ")],
        "5 blocks an SM": _single(blocks=5),
        "3 blocks an SM": _single(blocks=3),
        "16 x 40 tiles, 5 blocks an SM": _single(16, 40, 47, blocks=5),
        "24 x 40 tiles": _single(24, 40, 47),
        "16 x 32 tiles (the multi-field kernel's), 5 blocks an SM": _single(16, 32, 41, blocks=5),
        "segments 4 / 4": _single_segments(4, 4),
        "segments 3 / 2": _single_segments(3, 2),
        "segments 2 / 4": _single_segments(2, 4),
    },
    "c_sw_tail": {
        "16 x 32 slots, 256 threads (the earlier design)": _c_sw_tail(16, 32, threads=256),
        "16 x 40 slots, 256 threads": _c_sw_tail(threads=256),
        "16 x 40 slots, 512 threads": _c_sw_tail(threads=512),
        "4 blocks an SM": _c_sw_tail(blocks=4),
        "8 x 40 slots, 256 threads": _c_sw_tail(8, threads=256),
        "8 x 40 slots, 320 threads": _c_sw_tail(8, threads=320),
        "12 x 40 slots": _c_sw_tail(12),
        "14 x 40 slots, 352 threads": _c_sw_tail(14, threads=352),
        "20 x 40 slots, 480 threads": _c_sw_tail(20, threads=480),
        "16 x 36 slots": _c_sw_tail(16, 36),
        "8 x 32 slots, 256 threads": _c_sw_tail(8, 32, threads=256),
    },
    "d2a2c": {
        "16 x 32 tiles, one level a step, 16 levels a block (the earlier design)":
            _d2a2c(16, 32, 16, step=1),
        "one level a step": _d2a2c(step=1),
        "three levels a step": _d2a2c(step=3),
        "11 x 40 tiles": _d2a2c(11),
        "14 x 40 tiles": _d2a2c(14),
        "10 x 40 tiles": _d2a2c(10),
        "20 levels a block": _d2a2c(levels=20),
        "40 levels a block": _d2a2c(levels=40),
    },
    "hydro": {
        "64 threads a block": _hydro(64, blocks=32),
        "256 threads a block": _hydro(256, blocks=8),
        "chunks of 2 levels": _hydro(chunk=2),
        "chunks of 8 levels": _hydro(chunk=8),
        "chunks of 16 levels": _hydro(chunk=16),
        "at most 40 registers": _hydro(blocks=12),
        "chunks of 8 levels, at most 40 registers": _hydro(chunk=8, blocks=12),
        "no register cap": _hydro(blocks=1),
        "levels unrolled by 1": [(_HYDRO_UNROLL, _HYDRO_UNROLL.replace("unroll 2", "unroll 1"))],
        "levels unrolled by 4": [(_HYDRO_UNROLL, _HYDRO_UNROLL.replace("unroll 2", "unroll 4"))],
    },
    "updatedz_c": {
        "4 blocks an SM (64 registers; f32 only)": _updatedz_c(blocks=4),
        "6 blocks an SM (40 registers)": _updatedz_c(blocks=6, blocks64=6),
        "no register cap": _updatedz_c(blocks=1, blocks64=1),
        "levels unrolled by 1 (f32 only)": _updatedz_c(unroll=1),
        "levels unrolled by 2 (f64 only)": _updatedz_c(unroll64=2),
        "levels unrolled by 4": _updatedz_c(unroll=4, unroll64=4),
        "128 threads a block": _updatedz_c(threads=128, blocks=16, blocks64=8),
        "1024 threads a block": _updatedz_c(threads=1024, blocks=2, blocks64=1),
        "40 levels a thread": _updatedz_c(levels=40),
        "20 levels a thread": _updatedz_c(levels=20),
    },
}


#: the kernel library each pick builds
LIBRARY = {"tracer": "fvtp2d", "single": "fvtp2d", "updatedz_c": "updatedz"}


def substituted(name, src, table):
    """``{label: source text}``: ``src`` with each entry of ``table``'s
    substitutions; raises before any build if a text is not in ``src``."""
    texts = {}
    for label, subs in table.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name} candidate {label!r}: {old!r} is not in the source")
            text = text.replace(old, new)
        texts[label] = text
    return texts


def candidate_sources(name):
    """``{candidate: source text}`` of kernel ``name``; raises before any
    build if a substitution's text is not in the source."""
    src = (_build.CSRC / _build.SOURCES[LIBRARY.get(name, name)]).read_text()
    return substituted(name, src, {**CANDIDATES[name], **DIAGNOSTICS[name]})


def earlier_sources(name, prev_dir):
    """``{label: source text}`` of ``EARLIER[name]`` on the earlier source of
    kernel ``name`` in ``prev_dir``."""
    src = (Path(prev_dir) / _build.SOURCES[LIBRARY.get(name, name)]).read_text()
    return substituted(name, src, EARLIER[name])


def build_candidates(name, prev_dir=None):
    """``{candidate: CDLL}`` of the candidates of kernel ``name`` (and, with
    ``prev_dir``, of its earlier source's ``EARLIER`` entries), built in
    parallel; every build is waited for before a failure raises."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    texts = candidate_sources(name)
    if prev_dir is not None and name in EARLIER:
        texts.update(earlier_sources(name, prev_dir))
    procs = {}
    for n, (label, text) in enumerate(texts.items()):
        cu = out_dir / f"{name}_{n}.cu"
        cu.write_text(text)
        lib = out_dir / f"lib{name}_{n}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True), lib)
    libs, failed = {}, []
    for label, (p, lib) in procs.items():
        text, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{name} candidate {label!r} failed to build:\n{text}")
            continue
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name} {label}: {line.strip()}")
        libs[label] = ctypes.CDLL(str(lib))
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def time_candidates(name, call, libs, reps=20, library=None):
    """Two rounds over the current build and the candidates."""
    lib_name = library or LIBRARY.get(name, name)
    current = _build.library(lib_name)
    order = {"current": current, **libs}
    ref = None
    for rnd in (1, 2):
        for label, lib in order.items():
            _build._LIBS[lib_name] = lib
            out = ab.flat(call())
            ref = ref if ref is not None else out
            same = all(torch.equal(a, b) for a, b in zip(out, ref))
            log(f"[variant] {name} {label} (round {rnd}): "
                f"{chip_smoke.time_ms(call, reps):.4f} ms, the current build's bits: {same}")
    _build._LIBS[lib_name] = current


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default="sim1,fvtp2d")
    ap.add_argument("--n", type=int, default=192)
    ap.add_argument("--npz", type=int, default=79)
    ap.add_argument("--prev", default=None,
                    help="directory of earlier sources: time those EARLIER lists too")
    args = ap.parse_args()
    picked = [k.strip() for k in args.kernels.split(",") if k.strip()]
    if not set(picked) <= set(CANDIDATES):
        ap.error(f"--kernels picks from {sorted(CANDIDATES)}")
    if not torch.cuda.is_available():
        print("torch_kernel_variants: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"card: {smi}")
    _build.build(sorted({LIBRARY.get(k, k) for k in picked}))
    if "sim1" in picked:
        from pace_tpu_torch.ops import sim1_kernel as s1k

        s_args, dt2, ptop, p_fac = ab.sim1_operands(args.n, args.npz, dev)
        time_candidates("sim1", lambda: s1k.sim1_solver_cuda(*s_args, dt2, ptop, p_fac=p_fac),
                        build_candidates("sim1"))
        del s_args
        torch.cuda.empty_cache()
    if "fvtp2d" in picked:
        from pace_tpu_torch.ops import fvtp2d_kernel as fk

        trio, ops = ab.transport_operands(args.n, args.npz, dev)
        time_candidates("fvtp2d", lambda: fk.fvtp2d_multi_cuda(trio, *ops[:5], mfx=ops[5],
                                                               mfy=ops[6]),
                        build_candidates("fvtp2d"))
        del trio, ops
        torch.cuda.empty_cache()
    if "tracer" in picked:
        from pace_tpu_torch.ops import fvtp2d_kernel as fk

        targs, _single = ab.tracer_operands(args.n, args.npz, dev)
        time_candidates("tracer", lambda: fk.fvtp2d_tracer_cuda(*targs),
                        build_candidates("tracer"), reps=5)
        del targs, _single
        torch.cuda.empty_cache()
    if "single" in picked:
        from pace_tpu_torch.ops import fvtp2d_kernel as fk

        singles = ab.transport_operands(args.n, args.npz, dev, singles=True)
        time_candidates("single", lambda: [fk.fvtp2d_cuda(*a) for a in singles.values()],
                        build_candidates("single"))
        del singles
        torch.cuda.empty_cache()
    if "c_sw_tail" in picked:
        from pace_tpu_torch.ops import c_sw_tail_kernel as ck

        c_args = ab.c_sw_tail_operands(args.n, args.npz, dev)
        time_candidates("c_sw_tail", lambda: ck.c_sw_tail_cuda(*c_args),
                        build_candidates("c_sw_tail"))
        del c_args
        torch.cuda.empty_cache()
    if "d2a2c" in picked:
        from pace_tpu_torch.ops import d2a2c_kernel as d2k

        d_args = ab.d2a2c_operands(args.n, args.npz, dev)
        time_candidates("d2a2c", lambda: d2k.d2a2c_cuda(*d_args), build_candidates("d2a2c"))
        del d_args
        torch.cuda.empty_cache()
    if "hydro" in picked:
        from pace_tpu_torch.ops import hydro_kernel as hyk

        h_args = ab.hydro_operands(args.n, args.npz, dev)
        libs = build_candidates("hydro")
        for need in ab.HYDRO_FORMS:
            time_candidates(f"hydro need={need}", lambda: hyk.hydrostatic_interfaces_cuda(
                *h_args, need=need), libs, library="hydro")
        del h_args
        torch.cuda.empty_cache()
    if "updatedz_c" in picked:
        from pace_tpu_torch.ops import updatedz_kernel as uzk

        u_args = ab.updatedz_c_operands(args.n, args.npz, dev)
        libs = build_candidates("updatedz_c", args.prev)
        for dtype in (torch.float32, torch.float64):
            a = [t.to(dtype).contiguous() for t in u_args[:5]] + [u_args[5]]
            time_candidates(f"updatedz_c {str(dtype)[6:]}", lambda: uzk.updatedz_c_cuda(*a),
                            libs, library="updatedz")
            del a
        del u_args
        torch.cuda.empty_cache()
    if "d_sw_tail" in picked:
        from pace_tpu_torch.ops import d_sw_tail_kernel as dtk

        (_label, t_args), _other = ab.tail_operands(args.n, args.npz, dev)
        time_candidates("d_sw_tail", lambda: dtk.d_sw_tail_cuda(*t_args),
                        build_candidates("d_sw_tail"))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
