"""``bench.py``'s seeded tracer block: every tracer uniform in
``[low, high]`` kg/kg (``bench.py`` draws ``1e-3 * (0.1 + U)``, so
``[1e-4, 1.1e-3]``), over the whole block, halos included."""

from __future__ import annotations

import dataclasses


def apply(state, params, draws, n_halo):
    lo, hi = float(params["low"]), float(params["high"])
    q = state.q
    u = draws.rand(q.shape, q)
    return dataclasses.replace(state, q=lo + (hi - lo) * u)
