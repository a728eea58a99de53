"""A seeded perturbation of ``pt`` on top of the analytic initial state.

Uniform white noise of ``amplitude_K`` kelvin (each point in
``[-amplitude_K, amplitude_K]``) on the compute domain of every layer; the
halos are left to the first exchange. ``delz`` and the other fields keep
their analytic values, so a seed shifts the initial state by a small
imbalance and no more: the same grid, the same steps and the same work,
a different trajectory.
"""

from __future__ import annotations

import dataclasses


def apply(state, params, draws, n_halo):
    amp = float(params["amplitude_K"])
    h = n_halo
    pt = state.pt.clone()
    inner = pt[..., h:-h, h:-h]
    noise = draws.rand(inner.shape, pt)
    inner += amp * (2.0 * noise - 1.0)
    return dataclasses.replace(state, pt=pt)
