"""The port's fvtp2d against pace_tpu's.

The plain PyTorch versions of the fused transport kernel (``fvtp2d_plain``,
``fvtp2d_tracer_plain``) must reproduce pace_tpu's XLA formulation and its
Pallas kernels in interpret mode on the consumed region (every interface but
the outer 3 rows/columns, as in tests/main/test_fvtp2d_pallas.py), in float64
to rtol 1e-12: the two frameworks evaluate the same operations in the same
order, so only round-off of a fused multiply-add in XLA's CPU code separates
them. The CUDA kernel itself runs only on the card (chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.ops.folds import CornerPatch as JCornerPatch
from pace_tpu.ops.fvtp2d import flux_divergence as jflux_divergence
from pace_tpu.ops.fvtp2d import fvtp2d as jfvtp2d
from pace_tpu.ops.fvtp2d_pallas import fvtp2d_pallas, fvtp2d_tracer_pallas
from pace_tpu_torch.ops import fvtp2d_kernel as fk
from pace_tpu_torch.ops.folds import CornerPatch
from pace_tpu_torch.ops.fvtp2d import flux_divergence, fvtp2d, fvtp2d_best

RTOL = 1e-12
H = 3
INNER = np.s_[..., H:-H, H:-H]


def _inputs(seed, S=2, K=3, Y=18, X=18, nq=None):
    """Random operands as numpy arrays; the y-fold differs from the x-fold
    only in its corner pack, as after a halo exchange."""
    rng = np.random.default_rng(seed)

    def mk(lead, dy=0, dx=0, scale=1.0):
        return scale * rng.standard_normal(lead + (Y + dy, X + dx))

    lead = (S, K) if nq is None else (S, nq, K)
    return {
        "qx": mk(lead) + 10.0,
        "qp": 10.0 + rng.standard_normal(lead + (2 * H, 2 * H)),
        "crx": mk((S, K), dx=1, scale=0.3),
        "cry": mk((S, K), dy=1, scale=0.3),
        "xfx": mk((S, K), dx=1, scale=0.5),
        "yfx": mk((S, K), dy=1, scale=0.5),
        "mfx": mk((S, K), dx=1, scale=0.5),
        "mfy": mk((S, K), dy=1, scale=0.5),
        "area": 10.0 + rng.random((S, Y, X)),
    }


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, ref):
    got, ref = np.asarray(got)[INNER], np.asarray(ref)[INNER]
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())


@pytest.mark.parametrize("hord", [5, 6, 7, 8])
@pytest.mark.parametrize("use_mf", [False, True], ids=["xfx", "mfx"])
def test_fvtp2d_plain_matches_pace_tpu(hord, use_mf):
    a = _inputs(100 + hord)
    names = ("crx", "cry", "xfx", "yfx", "area")
    jkw = dict(mfx=jnp.asarray(a["mfx"]), mfy=jnp.asarray(a["mfy"])) if use_mf else {}
    tkw = dict(mfx=_t(a["mfx"]), mfy=_t(a["mfy"])) if use_mf else {}
    jargs = [jnp.asarray(a[n]) for n in names]
    targs = [_t(a[n]) for n in names]
    jqy = JCornerPatch(jnp.asarray(a["qp"]))
    ref = jfvtp2d(jnp.asarray(a["qx"]), jqy, *jargs, hord, **jkw)
    kx, ky = fvtp2d_pallas(
        jnp.asarray(a["qx"]), jqy, *jargs, hord, interpret=True, **jkw
    )
    fx, fy = fk.fvtp2d_plain(_t(a["qx"]), CornerPatch(_t(a["qp"])), *targs, hord, **tkw)
    for got, r, k in ((fx, ref.fx, kx), (fy, ref.fy, ky)):
        _close(got.numpy(), r)
        _close(got.numpy(), k)
    # the dispatching entry point takes the plain version for CPU tensors
    best = fvtp2d_best(_t(a["qx"]), CornerPatch(_t(a["qp"])), *targs, hord, **tkw)
    assert torch.equal(best.fx, fx) and torch.equal(best.fy, fy)


def test_fvtp2d_hord1_and_full_qy():
    """First-order upwind, and a full y-fold tensor instead of a pack."""
    a = _inputs(7)
    names = ("crx", "cry", "xfx", "yfx", "area")
    qy = a["qx"] + 0.01 * np.random.default_rng(8).standard_normal(a["qx"].shape)
    ref = jfvtp2d(jnp.asarray(a["qx"]), jnp.asarray(qy), *[jnp.asarray(a[n]) for n in names], 1)
    got = fvtp2d(_t(a["qx"]), _t(qy), *[_t(a[n]) for n in names], 1)
    _close(got.fx.numpy(), ref.fx)
    _close(got.fy.numpy(), ref.fy)


def test_fvtp2d_tracer_plain_matches_pace_tpu():
    """The tracer block (nq=2, hord 8, mass fluxes) against the Pallas
    tracer kernel in interpret mode and the per-tracer XLA formulation."""
    a = _inputs(21, nq=2)
    names = ("crx", "cry", "xfx", "yfx", "area", "mfx", "mfy")
    jargs = [jnp.asarray(a[n]) for n in names]
    kx, ky = fvtp2d_tracer_pallas(
        jnp.asarray(a["qx"]), JCornerPatch(jnp.asarray(a["qp"])), *jargs, 8, interpret=True
    )
    fx, fy = fk.fvtp2d_tracer(
        _t(a["qx"]), CornerPatch(_t(a["qp"])), *[_t(a[n]) for n in names], 8
    )
    assert fx.shape == tuple(kx.shape) and fy.shape == tuple(ky.shape)
    _close(fx.numpy(), kx)
    _close(fy.numpy(), ky)
    for t in range(2):
        ref = jfvtp2d(
            jnp.asarray(a["qx"][:, t]), JCornerPatch(jnp.asarray(a["qp"][:, t])),
            *jargs[:5], 8, mfx=jargs[5], mfy=jargs[6],
        )
        _close(fx[:, t].numpy(), ref.fx)
        _close(fy[:, t].numpy(), ref.fy)


def test_flux_divergence_matches_pace_tpu():
    rng = np.random.default_rng(3)
    fx = rng.standard_normal((2, 3, 10, 11))
    fy = rng.standard_normal((2, 3, 11, 10))
    rarea = rng.random((2, 10, 10))
    ref = jflux_divergence(jnp.asarray(fx), jnp.asarray(fy), jnp.asarray(rarea))
    got = flux_divergence(_t(fx), _t(fy), _t(rarea))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=0)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never run the plain version: CPU operands raise
    before anything is built or launched."""
    a = _inputs(5)
    args = [_t(a[n]) for n in ("crx", "cry", "xfx", "yfx", "area")]
    with pytest.raises(ValueError, match="must be a"):
        fk.fvtp2d_cuda(_t(a["qx"]), CornerPatch(_t(a["qp"])), *args, 6)
    with pytest.raises(ValueError, match="unsupported hord"):
        fk.fvtp2d_cuda(_t(a["qx"]), CornerPatch(_t(a["qp"])), *args, 4)
