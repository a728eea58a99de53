"""Cube-corner (3-valent point) corrections for corner-registered quantities.

Port of ``pace_tpu.ops.corners``. Eight points of the cubed sphere join only
THREE tiles; any stencil assuming four quadrants around a corner point reads
the folded (duplicated) quadrant and is O(1) wrong there. The corrections
are point fixes driven by the static ``GridData.corner_table``; without a
table (a grid built from masks only) they fall back to masked tensor ops
driven by the ``corner_sw/se/nw/ne`` masks.

Quadrant offsets relative to corner (jj, ii): cell (jj+a, ii+b) with
(a, b) in {(0,0)=NE, (0,-1)=NW, (-1,0)=SE, (-1,-1)=SW}. The folded quadrant
per corner type: SW corner -> SW quadrant, SE -> SE, NW -> NW, NE -> NE.

Every function returns a new tensor; the inputs are never written.
"""

from __future__ import annotations

import torch

from .stencil_utils import (
    bcast_k,
    sx,
    sy,
    x_cell_to_left_iface,
    x_cell_to_right_iface,
    y_cell_to_left_iface,
    y_cell_to_right_iface,
)

# folded (duplicated) quadrant per corner kind
_FOLDED = {"sw": (-1, -1), "se": (-1, 0), "nw": (0, -1), "ne": (0, 0)}
_QUADRANTS = ((0, 0), (0, -1), (-1, 0), (-1, -1))


def cell_at_corner(q, a: int, b: int):
    """Cell value q[.., jj+a, ii+b] registered at corner (jj, ii)."""
    return y_cell_to_right_iface(x_cell_to_right_iface(sy(sx(q, b), a)))


def _corner_mask(grid, kind: str, like):
    m = {
        "sw": grid.corner_sw,
        "se": grid.corner_se,
        "nw": grid.corner_nw,
        "ne": grid.corner_ne,
    }[kind]
    return bcast_k(m, like)


def _cell_read(q, jj: int, ii: int, a: int, b: int):
    """Value of cell (jj+a, ii+b) at the single corner point (jj, ii): the
    indices wrap (modulo) like the full-array path's rolls, and a corner
    beyond the last cell row/column reads 0."""
    Y, X = q.shape[-2], q.shape[-1]
    if jj >= Y or ii >= X:
        return torch.zeros_like(q[..., 0, 0])
    return q[..., (jj + a) % Y, (ii + b) % X]


def _set_point(out, val, own, jj: int, ii: int, fresh: bool):
    """out[..., jj, ii] <- val on the shards flagged in ``own`` (static).
    ``fresh`` says ``out`` is already a private copy that may be written."""
    if not fresh:
        out = out.clone()
    if not all(own):
        cur = out[..., jj, ii]
        m = torch.as_tensor(own, dtype=torch.bool, device=out.device).reshape(
            (len(own),) + (1,) * (cur.ndim - 1)
        )
        val = torch.where(m, val, cur)
    out[..., jj, ii] = val
    return out


def _three_quadrants(kind, read):
    """Sum of ``read(a, b)`` over the three real quadrants of a ``kind``
    corner, in _QUADRANTS order."""
    acc = None
    for (a, b) in _QUADRANTS:
        if (a, b) == _FOLDED[kind]:
            continue
        val = read(a, b)
        acc = val if acc is None else acc + val
    return acc


def average_3_quadrants(q, grid, default):
    """Replace cube-corner points of a corner field ``default`` (built from
    4-quadrant center averages of ``q``) with the mean over the 3 REAL
    adjacent cells."""
    table = getattr(grid, "corner_table", ())
    out = default
    if table:
        fresh = False
        for kind, jj, ii, own in table:
            acc = _three_quadrants(kind, lambda a, b: _cell_read(q, jj, ii, a, b))
            out = _set_point(out, acc / 3.0, own, jj, ii, fresh)
            fresh = True
        return out
    for kind in ("sw", "se", "nw", "ne"):
        acc = _three_quadrants(kind, lambda a, b: cell_at_corner(q, a, b))
        mask = _corner_mask(grid, kind, out)
        out = torch.where(mask > 0.5, acc / 3.0, out)
    return out


def _diagonal_extrapolation(read):
    """Quadratic one-sided diagonal extrapolation to the corner (Lagrange at
    the corner of centers at 0.5, 1.5, 2.5 diagonal indices) of quadrant
    (a, b), values fetched by ``read``."""

    def ext(a, b):
        a2 = a + (1 if a >= 0 else -1)
        b2 = b + (1 if b >= 0 else -1)
        a3 = a + (2 if a >= 0 else -2)
        b3 = b + (2 if b >= 0 else -2)
        return 1.875 * read(a, b) - 1.25 * read(a2, b2) + 0.375 * read(a3, b3)

    return ext


def extrapolate_3_to_corner(q, grid, default):
    """Replace cube-corner points of an interpolated corner field with the
    mean of the 3 one-sided diagonal extrapolations (the analog of the
    reference a2b_ord4 extrap_corner treatment)."""
    table = getattr(grid, "corner_table", ())
    out = default
    if table:
        fresh = False
        for kind, jj, ii, own in table:
            ext = _diagonal_extrapolation(lambda a, b: _cell_read(q, jj, ii, a, b))
            out = _set_point(out, _three_quadrants(kind, ext) / 3.0, own, jj, ii, fresh)
            fresh = True
        return out
    ext = _diagonal_extrapolation(lambda a, b: cell_at_corner(q, a, b))
    for kind in ("sw", "se", "nw", "ne"):
        mask = _corner_mask(grid, kind, out)
        out = torch.where(mask > 0.5, _three_quadrants(kind, ext) / 3.0, out)
    return out


def dedup_corner_divergence(uf, vf, grid, c4):
    """Fix the 4-leg corner divergence at cube corners: the two legs that
    cross the folded face represent the SAME physical crossing; keep their
    average instead of their sum. ``c4`` is the uncorrected 4-leg outflow."""
    table = getattr(grid, "corner_table", ())
    if table:

        def read(arr, jj, ii):
            Y, X = arr.shape[-2], arr.shape[-1]
            if 0 <= jj < Y and 0 <= ii < X:
                return arr[..., jj, ii]
            return torch.zeros_like(arr[..., 0, 0])

        out = c4
        fresh = False
        for kind, jj, ii, own in table:
            if kind == "sw":
                dup = -read(uf, jj, ii - 1) - read(vf, jj - 1, ii)
            elif kind == "se":
                dup = read(uf, jj, ii) - read(vf, jj - 1, ii)
            elif kind == "nw":
                dup = -read(uf, jj, ii - 1) + read(vf, jj, ii)
            else:  # ne
                dup = read(uf, jj, ii) + read(vf, jj, ii)
            out = _set_point(out, c4[..., jj, ii] - 0.5 * dup, own, jj, ii, fresh)
            fresh = True
        return out

    uf_r = x_cell_to_right_iface(uf)
    uf_l = x_cell_to_left_iface(uf)
    vf_t = y_cell_to_right_iface(vf)
    vf_b = y_cell_to_left_iface(vf)
    dups = {
        "sw": -uf_l - vf_b,
        "se": uf_r - vf_b,
        "nw": -uf_l + vf_t,
        "ne": uf_r + vf_t,
    }
    out = c4
    for kind, dup in dups.items():
        mask = _corner_mask(grid, kind, out)
        out = torch.where(mask > 0.5, c4 - 0.5 * dup, out)
    return out
