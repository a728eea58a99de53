"""The port's vertical remap against pace_tpu's.

``remap_field`` of ``pace_tpu_torch`` for kord 4, 6, 7, 8, 9, 10 and -9
against ``pace_tpu``'s XLA ``remap_field`` and its Pallas kernel in
interpret mode (``remap_field_pallas(..., interpret=True)``), on columns made
from a seed (the inputs of ``tests/main/test_remap_pallas.py`` with a rough
field, so that every limiter acts), float64, including a tracer axis that
shares its pressure columns; the PPM helpers the remap reads; the kernel
wrapper's operand rules. Tolerance: rtol 1e-12 with atol 1e-12 of the largest
reference value, on whole columns. The remap conserves each column's
integral to 1e-12 of it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.ops import ppm as jppm
from pace_tpu.ops import remapping as jremap
from pace_tpu.ops.remap_pallas import remap_field_pallas
from pace_tpu_torch.ops import ppm, remap_kernel, remapping

RTOL = 1e-12
KORDS = (4, 6, 7, 8, 9, 10, -9)


def _columns(S=2, K=12, Y=5, X=7, seed=0):
    """Source and target interfaces with the same ends and target interfaces
    within a third of a layer of the source ones; a field with extrema,
    noise and negative values."""
    rng = np.random.RandomState(seed)
    ps = 1.0e5 + 1.0e3 * rng.randn(S, Y, X)
    bk = np.linspace(0.0, 1.0, K + 1) ** 1.5
    pe2 = 2.0 + bk[None, :, None, None] * (ps[:, None] - 2.0)
    pe1 = pe2.copy()
    dp_min = np.diff(pe2, axis=1).min()
    pe1[:, 1:-1] += 0.3 * dp_min * rng.randn(S, K - 1, Y, X)
    assert (np.diff(pe1, axis=1) > 0).all()
    q = np.sin(0.7 * np.arange(K))[None, :, None, None] + 0.4 * rng.randn(S, K, Y, X)
    return q, pe1, pe2


def _close(got, want, name=""):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max(),
                               err_msg=name)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.fixture(scope="module")
def columns():
    return _columns()


@pytest.mark.parametrize("kord", KORDS)
def test_remap_field_matches_xla(columns, kord):
    q, pe1, pe2 = columns
    want = jremap.remap_field(*(jnp.asarray(a) for a in (q, pe1, pe2)), kord)
    _close(remapping.remap_field(*_torch(q, pe1, pe2), kord), want, f"kord {kord}")


@pytest.mark.parametrize("kord", KORDS)
def test_remap_field_matches_pallas_interpret(columns, kord):
    q, pe1, pe2 = columns
    want = remap_field_pallas(*(jnp.asarray(a) for a in (q, pe1, pe2)), kord, interpret=True)
    _close(remapping.remap_field(*_torch(q, pe1, pe2), kord), want, f"kord {kord}")


@pytest.mark.parametrize("kord", [9, -9])
def test_tracer_axis_with_shared_columns(kord):
    """A (S, nq, K, Y, X) block on (S, 1, K+1, Y, X) columns: equal to the
    reference's remap of the block, and remap_tracers on the (S, K+1, Y, X)
    columns equal to it."""
    q, pe1, pe2 = _columns(K=10, seed=1)
    rng = np.random.RandomState(2)
    qb = np.stack([q, 2.0 + q, rng.rand(*q.shape)], axis=1)
    want = jremap.remap_field(*(jnp.asarray(a) for a in (qb, pe1[:, None], pe2[:, None])), kord)
    want_p = remap_field_pallas(*(jnp.asarray(a) for a in (qb, pe1[:, None], pe2[:, None])),
                                kord, interpret=True)
    tq, tpe1, tpe2 = _torch(qb, pe1, pe2)
    got = remapping.remap_field(tq, tpe1[:, None], tpe2[:, None], kord)
    _close(got, want, "block vs xla")
    _close(got, want_p, "block vs pallas")
    assert torch.equal(remapping.remap_tracers(tq, tpe1, tpe2, kord), got)


@pytest.mark.parametrize("kord", KORDS)
def test_remap_conserves_column_integrals(columns, kord):
    q, pe1, pe2 = columns
    out = remapping.remap_field(*_torch(q, pe1, pe2), kord).numpy()
    before = (q * np.diff(pe1, axis=1)).sum(axis=1)
    after = (out * np.diff(pe2, axis=1)).sum(axis=1)
    scale = (np.abs(q) * np.diff(pe1, axis=1)).sum(axis=1)
    assert (np.abs(after - before) / scale).max() <= 1e-12


def test_remap_identity_columns():
    q, pe1, _pe2 = _columns(seed=3)
    out = remapping.remap_field(*_torch(q, pe1, pe1), 9)
    np.testing.assert_allclose(out.numpy(), q, rtol=0, atol=1e-12 * np.abs(q).max())


@pytest.mark.parametrize("name", ["_limited_slope", "_al_limited", "_al_unlimited"])
def test_ppm_interface_helpers_match(name):
    q = _columns(seed=4)[0]
    want = getattr(jppm, name)(jnp.asarray(q), lambda a, n: jnp.roll(a, -n, axis=-3))
    got = getattr(ppm, name)(torch.from_numpy(q), lambda a, n: torch.roll(a, -n, dims=-3))
    _close(got, want, name)


@pytest.mark.parametrize("name", ["_monotone_limit", "_positive_limit"])
def test_ppm_limiters_match(name):
    rng = np.random.RandomState(5)
    q, bl, br = rng.randn(3, 2, 9, 4, 6)
    want = getattr(jppm, name)(*(jnp.asarray(a) for a in (q, bl, br)))
    got = getattr(ppm, name)(*_torch(q, bl, br))
    for a, b in zip(got, want):
        _close(a, b, name)


@pytest.mark.parametrize("which", ["u", "v"])
def test_pe_at_wind_points_match(which):
    pe = _columns(seed=6)[1]
    fn = f"pe_at_{which}_points"
    _close(getattr(remapping, fn)(torch.from_numpy(pe)), getattr(jremap, fn)(jnp.asarray(pe)), fn)


def test_remap_field_best_takes_the_plain_version_on_cpu(columns):
    q, pe1, pe2 = _torch(*columns)
    before = dict(remap_kernel.LAUNCHES)
    assert torch.equal(remapping.remap_field_best(q, pe1, pe2, -9),
                       remapping.remap_field(q, pe1, pe2, -9))
    assert remap_kernel.LAUNCHES == before


def test_kernel_wrapper_operand_rules(columns):
    q, pe1, pe2 = _torch(*columns)
    with pytest.raises(ValueError, match="CUDA device"):
        remap_kernel.remap_cuda(q, pe1, pe2, 9)
    qb = q[:, None].expand(2, 3, *q.shape[1:])
    assert remap_kernel._repeat(tuple(qb.shape[:-3]), (2, 1), "pe1") == 3
    with pytest.raises(ValueError, match="must equal"):
        remap_kernel._repeat((2, 3), (1, 3), "pe1")
