"""Round-off perturbation of model states.

Port of ``pace_tpu.testing.perturb`` (reference role:
``ndsl.testing.perturb``, used by the threshold calibration). The walk over
a state's dataclass fields visits the populated fields in declaration order,
the order in which ``jax.tree_util`` visits the leaves of ``pace_tpu``'s
registered ``DycoreState``, so one seed perturbs both packages' states
identically.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .checkpointer import _concrete


def perturb(state, magnitude: float = 1.0e-13, seed: int = 0):
    """Multiply every floating-point tensor by (1 + eps) with |eps| <=
    ``magnitude`` — a round-off-scale perturbation for calibrating how fast
    trajectories diverge. ``state`` is a dataclass of tensors (or one
    tensor); it is not written."""
    rng = np.random.RandomState(seed)

    def _one(leaf):
        if leaf is None:
            return None
        arr = _concrete(leaf)
        if not np.issubdtype(arr.dtype, np.floating):
            return leaf
        eps = rng.uniform(-magnitude, magnitude, size=arr.shape)
        out = torch.from_numpy(np.ascontiguousarray(arr * (1.0 + eps)))
        return out.to(device=leaf.device, dtype=leaf.dtype)

    if dataclasses.is_dataclass(state):
        return dataclasses.replace(state, **{
            f.name: _one(getattr(state, f.name))
            for f in dataclasses.fields(state)
            if getattr(state, f.name) is not None
        })
    return _one(state)
