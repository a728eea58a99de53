"""Corner-fold patches: the y-fold of an exchanged field as (x-fold + tiny
corner pack) instead of a second full-size tensor.

The x and y corner-fold conventions of a halo exchange differ ONLY in the
four (h x h) corner ghost regions. ``CornerPatch`` carries the y-fold's
corner values packed [[SW, SE], [NW, NE]] into a (…, 2h, 2h) tensor;
``apply_corner_patch`` reconstructs the full y-fold. The fvtp2d kernel
applies the pack while staging its tiles in shared memory, so the second
full-size tensor never exists in device memory.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CornerPatch(NamedTuple):
    """Marker: corner pack of the y-fold, (…, 2h, 2h)."""

    data: torch.Tensor


def apply_corner_patch(q: torch.Tensor, patch) -> torch.Tensor:
    """Full y-fold from the x-fold ``q`` and its corner pack (a new tensor)."""
    if isinstance(patch, CornerPatch):
        patch = patch.data
    h = patch.shape[-1] // 2
    Y, X = q.shape[-2:]
    q = q.clone()
    q[..., :h, :h] = patch[..., :h, :h]
    q[..., :h, X - h :] = patch[..., :h, h:]
    q[..., Y - h :, :h] = patch[..., h:, :h]
    q[..., Y - h :, X - h :] = patch[..., h:, h:]
    return q


def materialize_qy(qx: torch.Tensor, qy) -> torch.Tensor:
    """qy operand normalization: CornerPatch -> full tensor, else as-is."""
    if isinstance(qy, CornerPatch):
        return apply_corner_patch(qx, qy.data)
    return qy
