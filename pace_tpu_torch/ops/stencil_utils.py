"""Shift/slice helpers for writing stencils on halo-padded tensors.

Convention (as ``pace_tpu.ops.stencil_utils``): fields are ``(..., Y, X)``
with ``n_halo`` ghost rows/cols on each side. ``sx(a, n)`` returns the
tensor whose value at index ``i`` is ``a[i + n]`` along the x (last) axis;
``sy`` the same along y. Shifts are ``torch.roll``, so values wrap at the
array boundary — harmless because stencils only read shifted values inside
the halo-covered region, and the outermost halo ring is never consumed at
full stencil width.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..utils import ranges


def sx(a: torch.Tensor, n: int) -> torch.Tensor:
    """a shifted so result[..., i] = a[..., i + n]."""
    if n == 0:
        return a
    return torch.roll(a, -n, dims=-1)


def sy(a: torch.Tensor, n: int) -> torch.Tensor:
    """a shifted so result[..., j, :] = a[..., j + n, :]."""
    if n == 0:
        return a
    return torch.roll(a, -n, dims=-2)


#: the 0-dim tensors :func:`scalar_like` has made, by (value, dtype, device)
_SCALARS: Dict[tuple, torch.Tensor] = {}


def scalar_like(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-dim tensor of ``like``'s dtype and device. Dividing by it
    is a true division on CUDA tensors too: PyTorch turns a division by a
    Python number into a multiplication by its reciprocal there.

    The tensor is made once per value, dtype and device and handed back on
    every later call: it is shared, and no caller may write into it. Only
    the first call for a key copies ``x`` to the device; on the card that
    copy waits for the stream (PyTorch's blocking copy), a host sync
    counted under ``scalar_like``. A later call adds one to
    ``ranges.SCALAR_REUSES`` instead. The keys are configuration constants
    (6, 3, GRAV, P_REF, the step's ``dt``, ``mdt`` and ``dt2``, ``rf_cutoff``
    and its log-pressure span), a few dozen in a process, so the cache needs
    no bound. The value is keyed by its bits (``float.hex``), so ``-0.0``
    and ``0.0`` stay apart."""
    key = (float(x).hex(), like.dtype, like.device)
    t = _SCALARS.get(key)
    if t is not None:
        ranges.SCALAR_REUSES += 1
        return t
    with ranges.host_sync("scalar_like"):
        t = _SCALARS[key] = torch.tensor(x, dtype=like.dtype, device=like.device)
    return t


def bcast_k(g: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a 2-D-per-shard grid tensor (S, Y, X) against a field with
    extra axes between S and (Y, X), e.g. (S, K, Y, X) or (S, nq, K, Y, X)."""
    while g.ndim < like.ndim:
        g = g.unsqueeze(1)
    return g


def swap_xy(a: torch.Tensor) -> torch.Tensor:
    """Transpose the trailing (Y, X) axes."""
    return a.transpose(-1, -2)


# ---------------------------------------------------------------------------
# Staggering helpers. Convention: interface index ii along an axis lies
# between cells ii-1 and ii; interface arrays are one longer than cell arrays.
# Pads replicate the edge so outer-halo values stay finite (never consumed).
# ---------------------------------------------------------------------------


def _pad(a: torch.Tensor, axis: int, before: int, after: int) -> torch.Tensor:
    """Edge-replicating pad along ``axis``."""
    n = a.shape[axis]
    parts = (
        [a.narrow(axis, 0, 1)] * before + [a] + [a.narrow(axis, n - 1, 1)] * after
    )
    return torch.cat(parts, dim=axis) if len(parts) > 1 else a


def x_cell_to_left_iface(g):
    """left[..., ii] = g[..., ii-1]: cell value left of x-interface ii.
    (..., X) -> (..., X+1)."""
    return _pad(g, -1, 1, 0)


def x_cell_to_right_iface(g):
    """right[..., ii] = g[..., ii]: cell value right of x-interface ii."""
    return _pad(g, -1, 0, 1)


def y_cell_to_left_iface(g):
    """left[..., jj, :] = g[..., jj-1, :]. (..., Y, X) -> (..., Y+1, X)."""
    return _pad(g, -2, 1, 0)


def y_cell_to_right_iface(g):
    return _pad(g, -2, 0, 1)


def x_iface_diff(f):
    """Per-cell divergence contribution f[..., ii] - f[..., ii+1]:
    (..., X+1) -> (..., X). Positive f = flow in +x, so in-minus-out."""
    return f[..., :-1] - f[..., 1:]


def y_iface_diff(f):
    """f[..., jj, :] - f[..., jj+1, :]: (..., Y+1, X) -> (..., Y, X)."""
    return f[..., :-1, :] - f[..., 1:, :]


def x_iface_to_cell(f):
    """Average the two x-interfaces of each cell: (..., X+1) -> (..., X)."""
    return 0.5 * (f[..., :-1] + f[..., 1:])


def y_iface_to_cell(f):
    return 0.5 * (f[..., :-1, :] + f[..., 1:, :])
