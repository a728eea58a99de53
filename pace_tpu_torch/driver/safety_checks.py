"""Runtime bounds and NaN checks on state variables.

Port of ``pace_tpu.driver.safety_checks`` (reference role: ``SafetyChecker``).
Each check's NaN test, minimum and maximum are computed on the device, and
only those scalars, for all checks at once, move to the host; on a mesh
they are reduced over the ranks first, so that every rank raises alike.
"""

from __future__ import annotations

from typing import List

import torch

from ..parallel.mesh import all_reduce, get_shard_mesh
from ..utils.ranges import host_sync


class SafetyChecker:
    def __init__(self):
        self.checks: List = []

    def register_variable(
        self,
        name: str,
        minimum_value=None,
        maximum_value=None,
        compute_domain_only: bool = True,
    ):
        self.checks.append((name, minimum_value, maximum_value, compute_domain_only))

    def check_state(self, state, n_halo: int = 3):
        """Raises RuntimeError on a violation."""
        rows, stats = [], []
        for name, lo, hi, interior in self.checks:
            a = getattr(state, name, None)
            if a is None:
                continue
            if interior and a.ndim >= 2:
                a = a[..., n_halo:-n_halo, n_halo:-n_halo]
            rows.append((name, lo, hi))
            stats.append(torch.stack([torch.isnan(a).any().to(a.dtype), a.min(), a.max()]))
        if not rows:
            return
        # one transfer of three scalars a check; numpy scalars print as
        # pace_tpu's messages print them. On a mesh: the NaN flags, minima
        # and maxima of every rank's shards, one all-reduce (max of the
        # negated minima)
        values = torch.stack([s.to(stats[0].dtype) for s in stats])
        if get_shard_mesh() is not None:
            sign = torch.tensor([1.0, -1.0, 1.0], dtype=values.dtype, device=values.device)
            values = all_reduce(values * sign, "max") * sign
        with host_sync("safety_checks"):
            values = values.cpu().numpy()
        failures = []
        for (name, lo, hi), (nan, amin, amax) in zip(rows, values):
            if nan:
                failures.append(f"{name}: NaN detected")
                continue
            if lo is not None and amin < lo:
                failures.append(f"{name}: min {amin} < {lo}")
            if hi is not None and amax > hi:
                failures.append(f"{name}: max {amax} > {hi}")
        if failures:
            raise RuntimeError("safety check failed: " + "; ".join(failures))
