"""The port's C-grid half step (c_sw) and cube-corner fixes against pace_tpu's.

Same inputs (numpy, seeded) through both packages in float64 at C12.
Tolerance: rtol 1e-12 (atol 1e-12 of the largest reference value, for
points that cancel to zero), on the whole plane: the tail's pads replicate
the edge identically in both packages and in the Pallas kernel. The
reference is the XLA path (``c_sw_tail_jnp``, ``c_sw``) and the Pallas tail
kernel in interpret mode.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.grid.generation import GridSpec as JGridSpec
from pace_tpu.grid.generation import MetricTerms as JMetricTerms
from pace_tpu.grid.grid_data import GridData as JGridData
from pace_tpu.ops import c_sw as jc_sw
from pace_tpu.ops import corners as jcorners
from pace_tpu.ops.c_sw_tail_pallas import c_sw_tail_pallas
from pace_tpu_torch.grid.grid_data import GridData
from pace_tpu_torch.ops import c_sw, c_sw_tail_kernel, corners
from pace_tpu_torch.parallel.halo import HaloExchanger
from pace_tpu_torch.parallel.partitioner import CubedSpherePartitioner, TilePartitioner
from pace_tpu_torch.parallel.topology import cubed_sphere_topology

N, NPZ = 12, 3
RTOL = 1e-12
DT2 = 0.5 * 200.0 / 56
TAIL_OUT = ("delpc", "ptc", "uc_new", "vc_new", "ut", "vt", "xfx", "yfx", "divg_d")
STATE_FIELDS = ("delpc", "ptc", "uc", "vc", "ut", "vt", "ua", "va", "divg_d", "xfx", "yfx")


def _close(got, ref, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        got, ref, rtol=RTOL, atol=RTOL * np.abs(ref).max(), err_msg=what
    )


def grid_arrays(jgrid):
    out = {}
    for f in dataclasses.fields(jgrid):
        v = getattr(jgrid, f.name)
        out[f.name] = v if np.isscalar(v) or isinstance(v, tuple) else np.asarray(v)
    return out


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def setup():
    mt = JMetricTerms.generate(JGridSpec(n_tile=N, npz=NPZ, layout=(1, 1)))
    jgrid = JGridData.from_metric_terms(mt, dtype=jnp.float64)
    tgrid = GridData.from_numpy(grid_arrays(jgrid), device="cpu", dtype=torch.float64)
    thalo = HaloExchanger(
        cubed_sphere_topology(), CubedSpherePartitioner(TilePartitioner((1, 1))), N
    )
    S, Y, X = np.asarray(jgrid.area).shape
    rng = np.random.default_rng(11)

    def r(dy=0, dx=0, scale=10.0, offset=0.0):
        return offset + scale * rng.standard_normal((S, NPZ, Y + dy, X + dx))

    fields = dict(
        u=r(1, 0), v=r(0, 1), delp=r(scale=50.0, offset=1000.0),
        pt=r(scale=10.0, offset=300.0), uc=r(0, 1), vc=r(1, 0), uc_x=r(0, 1),
        vc_x=r(1, 0), uc_y=r(0, 1), vc_y=r(1, 0), ua=r(), va=r(), va_x=r(), ua_y=r(),
    )
    return dict(jgrid=jgrid, tgrid=tgrid, jhalo=mt.halo, thalo=thalo, fields=fields)


# ---------------------------------------------------------------------------
# corners.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", ["table", "masks"])
@pytest.mark.parametrize("fn", ["average_3_quadrants", "extrapolate_3_to_corner",
                                "dedup_corner_divergence"])
def test_corner_fixes_match(setup, fn, path):
    jgrid, tgrid = setup["jgrid"], setup["tgrid"]
    if path == "masks":  # a grid without the static table takes the mask path
        jgrid = dataclasses.replace(jgrid, corner_table=())
        tgrid = dataclasses.replace(tgrid, corner_table=())
    else:
        assert len(tgrid.corner_table) == 4
    f = setup["fields"]
    S, K, Y, X = f["delp"].shape
    default = np.random.default_rng(5).standard_normal((S, K, Y + 1, X + 1))
    if fn == "dedup_corner_divergence":
        jargs = (jnp.asarray(f["u"]), jnp.asarray(f["v"]), jgrid, jnp.asarray(default))
        targs = (_t(f["u"]), _t(f["v"]), tgrid, _t(default))
    else:
        jargs = (jnp.asarray(f["delp"]), jgrid, jnp.asarray(default))
        targs = (_t(f["delp"]), tgrid, _t(default))
    ref = np.asarray(getattr(jcorners, fn)(*jargs))
    got = getattr(corners, fn)(*targs).numpy()
    _close(got, ref, fn)
    # only the cube-corner points moved, and the input was not written
    changed = np.argwhere(got != default)
    assert 0 < len(changed) <= 4 * S * K
    assert torch.equal(targs[-1], _t(default))


def test_cell_at_corner_matches(setup):
    q = setup["fields"]["delp"]
    for a, b in ((0, 0), (-1, -1), (1, -2)):
        ref = jcorners.cell_at_corner(jnp.asarray(q), a, b)
        _close(corners.cell_at_corner(_t(q), a, b).numpy(), ref, f"cell_at_corner {a} {b}")


# ---------------------------------------------------------------------------
# c_sw.py pieces
# ---------------------------------------------------------------------------


def test_corner_vorticity_matches(setup):
    f = setup["fields"]
    for absolute in (True, False):
        ref = jc_sw.corner_vorticity(jnp.asarray(f["uc"]), jnp.asarray(f["vc"]),
                                     setup["jgrid"], absolute=absolute)
        got = c_sw.corner_vorticity(_t(f["uc"]), _t(f["vc"]), setup["tgrid"], absolute=absolute)
        _close(got.numpy(), ref, f"vort absolute={absolute}")


def test_divergence_corner_matches(setup):
    f = setup["fields"]
    names = ("u", "v", "va_x", "ua_y")
    ref = jc_sw.divergence_corner(*(jnp.asarray(f[n]) for n in names), setup["jgrid"])
    got = c_sw.divergence_corner(*(_t(f[n]) for n in names), setup["tgrid"])
    _close(got.numpy(), ref, "divergence_corner")


def test_area_fluxes_match(setup):
    f = setup["fields"]
    ref = jc_sw.c_grid_area_fluxes(jnp.asarray(f["uc"]), jnp.asarray(f["vc"]),
                                   setup["jgrid"], DT2)
    got = c_sw.c_grid_area_fluxes(_t(f["uc"]), _t(f["vc"]), setup["tgrid"], DT2)
    for g, r_, nm in zip(got, ref, ("xfx", "yfx")):
        _close(g.numpy(), r_, nm)


# ---------------------------------------------------------------------------
# the tail
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tails(setup):
    f = setup["fields"]
    order = c_sw_tail_kernel.FIELDS
    jf = [jnp.asarray(f[n]) for n in order]
    tf = [_t(f[n]) for n in order]
    return {
        "xla": jc_sw.c_sw_tail_jnp(*jf, setup["jgrid"], DT2),
        "pallas": c_sw_tail_pallas(*jf, setup["jgrid"], DT2, interpret=True),
        "plain": c_sw.c_sw_tail_plain(*tf, setup["tgrid"], DT2),
        "no_dedup": c_sw.c_sw_tail_plain(*tf, setup["tgrid"], DT2, dedup=False),
        "dispatched": c_sw.c_sw_tail(*tf, setup["tgrid"], DT2),
    }


@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize("idx", range(9), ids=TAIL_OUT)
def test_tail_matches(tails, idx, ref):
    _close(tails["plain"][idx].numpy(), tails[ref][idx], f"{TAIL_OUT[idx]} vs {ref}")


def test_tail_without_dedup_is_the_same(tails):
    """The kernels skip dedup_corner_divergence: the cube-corner average
    overwrites exactly the points it writes."""
    for a, b in zip(tails["plain"], tails["no_dedup"]):
        assert torch.equal(a, b)


def test_tail_cpu_tensors_take_the_plain_version(tails):
    for a, b in zip(tails["plain"], tails["dispatched"]):
        assert torch.equal(a, b)


def test_tail_kernel_rejects_cpu_tensors(setup):
    f = setup["fields"]
    args = [_t(f[n]) for n in c_sw_tail_kernel.FIELDS]
    with pytest.raises(ValueError, match="CUDA device"):
        c_sw_tail_kernel.c_sw_tail_cuda(*args, setup["tgrid"], DT2)


def test_tail_kernel_corner_arrays(setup):
    """The int32 tables the corner kernel reads: position, the three real
    quadrants in _QUADRANTS order, ownership."""
    table = setup["tgrid"].corner_table
    S = setup["tgrid"].area.shape[0]
    pos, quad, own = c_sw_tail_kernel.corner_arrays(table, S)
    assert pos.dtype == quad.dtype == own.dtype == torch.int32
    assert pos.shape == (len(table), 2) and quad.shape == (len(table), 3, 2)
    for n, (kind, jj, ii, flags) in enumerate(table):
        assert pos[n].tolist() == [jj, ii]
        real = [list(q) for q in corners._QUADRANTS if q != corners._FOLDED[kind]]
        assert quad[n].tolist() == real
        assert own[n].tolist() == [int(x) for x in flags]


def test_tail_kernel_stagger_tables(setup):
    """Every field, constant and result of the kernel has its staggering."""
    k = c_sw_tail_kernel
    assert set(k._FIELD_STAGGER) == set(k.FIELDS)
    assert set(k._CONST_STAGGER) | {"edge_y", "edge_x"} == set(k.CONSTS)
    S, Y, X = setup["tgrid"].area.shape
    for n, (dy, dx) in k._CONST_STAGGER.items():
        if hasattr(setup["tgrid"], n):
            assert tuple(getattr(setup["tgrid"], n).shape) == (S, Y + dy, X + dx), n
    w = c_sw.divergence_edge_weights(setup["tgrid"])
    assert [tuple(t.shape) for t in w] == [(S, Y + 1, X), (S, Y, X + 1), (S, Y + 1, 1), (S, 1, X + 1)]


# ---------------------------------------------------------------------------
# c_sw with the halo
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def c_sw_states(setup):
    f = setup["fields"]
    jhalo, thalo = setup["jhalo"], setup["thalo"]
    ju, jv = jhalo.update_vector_fold_pair(jnp.asarray(f["u"]), jnp.asarray(f["v"]), kind="dgrid")
    jdp, jpt = jhalo.update_scalars([jnp.asarray(f["delp"]), jnp.asarray(f["pt"])])
    ref = jc_sw.c_sw(ju, jv, jdp, jpt, setup["jgrid"], jhalo, DT2)
    tu, tv = thalo.update_vector_fold_pair(_t(f["u"]), _t(f["v"]), kind="dgrid")
    tdp, tpt = thalo.update_scalars([_t(f["delp"]), _t(f["pt"])])
    got = c_sw.c_sw(tu, tv, tdp, tpt, setup["tgrid"], thalo, DT2)
    return ref, got


@pytest.mark.parametrize("name", STATE_FIELDS)
def test_c_sw_matches(c_sw_states, name):
    ref, got = c_sw_states
    _close(getattr(got, name).numpy(), getattr(ref, name), name)
