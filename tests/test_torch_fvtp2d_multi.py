"""The port's multi-field fvtp2d against pace_tpu's.

``fvtp2d_multi_best`` on CPU tensors (the plain PyTorch version of the
multi-field kernel) against ``pace_tpu.ops.fvtp2d.fvtp2d_multi_best`` (the
XLA path) and ``fvtp2d_multi_pallas`` in interpret mode: three fields with
hord 6, 8 and 5, mass-flux and area-flux weights mixed, the y fold as a full
array and as a corner pack. Float64, same seeded numpy inputs; tolerance rtol
1e-12 with atol 1e-12 of the largest reference flux on the consumed region
(every interface but the outer 3 rows/columns, as in
tests/main/test_fvtp2d_pallas.py). Against single-field calls of the port the
result is exactly equal. The CUDA kernel itself runs only on the card
(chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.ops.folds import CornerPatch as JCornerPatch
from pace_tpu.ops.fvtp2d import fvtp2d_multi_best as jfvtp2d_multi_best
from pace_tpu.ops.fvtp2d_pallas import fvtp2d_multi_pallas
from pace_tpu_torch.ops import fvtp2d_kernel as fk
from pace_tpu_torch.ops.folds import CornerPatch
from pace_tpu_torch.ops.fvtp2d import Fluxes2D, fvtp2d, fvtp2d_multi_best

RTOL = 1e-12
H = 3
INNER = np.s_[..., H:-H, H:-H]
S, K, Y, X = 2, 3, 18, 18
#: (hord, use_mf, y fold as a corner pack) per field: d_sw's pt / vorticity /
#: w triple with the hords spread
SPECS = ((6, True, True), (8, False, True), (5, True, False))
SHARED = ("crx", "cry", "xfx", "yfx", "area")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(303)

    def mk(dy=0, dx=0, scale=1.0):
        return scale * rng.standard_normal((S, K, Y + dy, X + dx))

    a = {
        "crx": mk(dx=1, scale=0.3), "cry": mk(dy=1, scale=0.3),
        "xfx": mk(dx=1, scale=0.5), "yfx": mk(dy=1, scale=0.5),
        "mfx": mk(dx=1, scale=0.5), "mfy": mk(dy=1, scale=0.5),
        "area": 10.0 + rng.random((S, Y, X)),
    }
    qs = []
    for n, (_hord, _mf, patch) in enumerate(SPECS):
        qx = mk() * (1.0 + n) + 10.0
        qy = 10.0 + rng.standard_normal((S, K, 2 * H, 2 * H)) if patch else qx + 0.1 * mk()
        qs.append((qx, qy))
    a["q"] = qs
    return a


def _fields(a, to, patch_cls):
    return [(to(qx), patch_cls(to(qy)) if patch else to(qy), hord, mf)
            for (qx, qy), (hord, mf, patch) in zip(a["q"], SPECS)]


@pytest.fixture(scope="module")
def results(operands):
    a = operands
    jf = _fields(a, jnp.asarray, JCornerPatch)
    tf = _fields(a, _t, CornerPatch)
    jsh = [jnp.asarray(a[n]) for n in SHARED]
    tsh = [_t(a[n]) for n in SHARED]
    jmf = dict(mfx=jnp.asarray(a["mfx"]), mfy=jnp.asarray(a["mfy"]))
    tmf = dict(mfx=_t(a["mfx"]), mfy=_t(a["mfy"]))
    return {
        "fields": tf, "shared": tsh, "mf": tmf,
        "got": fvtp2d_multi_best(tf, *tsh, **tmf),
        "xla": [(f.fx, f.fy) for f in jfvtp2d_multi_best(jf, *jsh, **jmf)],
        "pallas": fvtp2d_multi_pallas(jf, *jsh, interpret=True, **jmf),
    }


@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize("out", ["fx", "fy"])
@pytest.mark.parametrize("field", range(len(SPECS)))
def test_multi_matches_pace_tpu(results, field, out, ref):
    got = getattr(results["got"][field], out).numpy()
    want = np.asarray(results[ref][field][("fx", "fy").index(out)])
    assert got.shape == want.shape
    got, want = got[INNER], want[INNER]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("field", range(len(SPECS)))
def test_multi_equals_single_field_calls(results, field):
    """Exactly: the multi-field call is the single-field formulation per
    field, with the weights each field asks for."""
    qx, qy, hord, use_mf = results["fields"][field]
    kw = results["mf"] if use_mf else {}
    single = fvtp2d(qx, qy, *results["shared"], hord, **kw)
    got = results["got"][field]
    assert isinstance(got, Fluxes2D)
    assert torch.equal(got.fx, single.fx) and torch.equal(got.fy, single.fy)


def test_multi_plain_is_what_cpu_tensors_take(results):
    plain = fk.fvtp2d_multi_plain(results["fields"], *results["shared"], **results["mf"])
    for g, (fx, fy) in zip(results["got"], plain):
        assert torch.equal(g.fx, fx) and torch.equal(g.fy, fy)


def test_multi_without_mass_fluxes(results):
    """No field asks for mass-flux weights: mfx/mfy may be absent."""
    fields = [(qx, qy, hord, False) for qx, qy, hord, _mf in results["fields"][:2]]
    out = fvtp2d_multi_best(fields, *results["shared"])
    for (qx, qy, hord, _mf), g in zip(fields, out):
        assert torch.equal(g.fx, fvtp2d(qx, qy, *results["shared"], hord).fx)


@pytest.mark.parametrize("case", ["shape", "qy_shape", "dtype", "hord", "no_mf", "too_many",
                                  "patch_width"])
def test_multi_rejects(results, case):
    f = results["fields"]
    q = f[2][0]
    fields, kw, match = list(f), results["mf"], "share shape"
    if case == "shape":
        fields[1] = (q[..., :-1, :], q[..., :-1, :], 6, False)
    elif case == "qy_shape":
        fields[2] = (q, q[..., :-1], 6, False)
    elif case == "dtype":
        fields[2], match = (q.float(), q.float(), 6, False), "share dtype"
    elif case == "hord":
        fields[2], match = (q, q, 3, False), "unsupported hord"
    elif case == "no_mf":
        kw, match = {}, "mfx/mfy missing"
    elif case == "too_many":
        fields, match = fields + fields, "1 to 4 fields"
    elif case == "patch_width":
        fields[1], match = (q, CornerPatch(q[..., :4, :4]), 6, False), "different widths"
    for fn in (fk.fvtp2d_multi_plain, fk.fvtp2d_multi_cuda):
        with pytest.raises(ValueError, match=match):
            fn(fields, *results["shared"], **kw)


def test_multi_kernel_rejects_cpu_tensors(results):
    """The kernel wrapper never runs the plain version: CPU input raises."""
    with pytest.raises(ValueError, match="CUDA device"):
        fk.fvtp2d_multi_cuda(results["fields"], *results["shared"], **results["mf"])
    assert fk.LAUNCHES["fvtp2d_multi"] == 0
