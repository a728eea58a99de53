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

import torch

from ..utils.ranges import host_sync


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


def scalar_like(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-dim tensor of ``like``'s dtype and device. Dividing by it
    is a true division on CUDA tensors too: PyTorch turns a division by a
    Python number into a multiplication by its reciprocal there.

    On the card the copy from the host waits for the stream (PyTorch's
    blocking copy): a host sync, counted under ``scalar_like``."""
    with host_sync("scalar_like"):
        return torch.tensor(x, dtype=like.dtype, device=like.device)


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
