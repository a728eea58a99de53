"""Seed recipes: the benchmark's inputs, made on the state's device from the
run's seed.

Each recipe is a module with ``apply(state, params, draws, n_halo)``: it
takes a dycore state (the program's or the reference's: the same field
names), the recipe's parameters from the cell's file, the run's
:class:`Draws` (seeded by the harness) and the halo width, and returns the
state with its seeded fields replaced (the input state is not written).
Draws are a few large :meth:`Draws.rand` calls in the state's dtype, so the
same seed gives the same arrays on both sides. A recipe is pointwise in the
state's fields otherwise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


class Draws:
    """A ``torch.Generator`` on the state's device, and the block of shards
    the state holds: ``(lo, hi, n_shards)`` on a rank of a mesh, None for
    the whole cube. On a block, :meth:`rand` draws the whole cube's array
    and keeps the block's shards, so that a run on N ranks starts from the
    numbers a single process draws."""

    def __init__(self, device, block: Optional[Tuple[int, int, int]] = None):
        self.gen = torch.Generator(device=device)
        self.block = block

    def seed(self, seed: int) -> None:
        self.gen.manual_seed(seed)

    def rand(self, shape, like: torch.Tensor) -> torch.Tensor:
        """``torch.rand(shape)`` in ``like``'s dtype and on its device,
        ``shape`` shard-leading."""
        shape = tuple(shape)
        if self.block is None:
            return torch.rand(shape, generator=self.gen, device=like.device, dtype=like.dtype)
        lo, hi, n = self.block
        if shape[0] != hi - lo:
            raise ValueError(f"a draw of {shape[0]} shards for a block of {hi - lo}")
        whole = torch.rand((n,) + shape[1:], generator=self.gen, device=like.device,
                           dtype=like.dtype)
        return whole[lo:hi].clone()
