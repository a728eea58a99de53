"""Fortran FV3GFS restart ingestion: the port against pace_tpu's reader on
synthesized restart directories, on the CPU in float64.

The directories are written by ``chip_smoke.write_fortran_restart`` from a
C12, npz=8 baroclinic state with seeded tracers and vertical velocity (both
packages have readers only). For layouts (1, 1) and (2, 2) both packages
load the same files and every field is bit-identical (NaN where both are
NaN: the Exner function of the zero halos before the exchange), and the
prognostics equal the written arrays bit for bit. ``coupler.res`` is parsed
as ``tests/main/test_fortran_restart.py`` parses the reference's sample; a
directory with ``fv_core.res.nc`` is taken as a Fortran restart by
initialization type ``restart`` too; the driver's clock starts at the
coupler's current time less its start time; the surface winds are read.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pace_tpu.driver import fortran_restart as jfr
from pace_tpu.grid.generation import GridSpec as JGridSpec
from pace_tpu.grid.generation import MetricTerms as JMetricTerms
from pace_tpu_torch.constants import TRACER_NAMES
from pace_tpu_torch.driver import fortran_restart as tfr
from pace_tpu_torch.driver.config import DriverConfig
from pace_tpu_torch.driver.driver import Driver
from pace_tpu_torch.grid.generation import GridSpec, MetricTerms
from pace_tpu_torch.models.fv3.state import DycoreState

H = 3
FIELDS = ("u", "v", "w", "delz", "delp", "pt", "q", "phis", "ps", "pe", "peln", "pk", "pkz",
          "ua", "va", "uc", "vc", "mfxd", "mfyd", "cxd", "cyd", "diss_estd")
WRITTEN = {"u": (1, 0), "v": (0, 1), "w": (0, 0), "delz": (0, 0), "delp": (0, 0),
           "phis": (0, 0)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the C12 arrays gain nothing from more, and the
    other workers of a parallel test run hold the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def synthesized_state(mt, seed):
    """A baroclinic state with seeded tracers, w and delz, its winds synced
    on the tile edges as a stepped state's are."""
    st = DycoreState.from_analytic_init(mt, device="cpu", dtype=torch.float64)
    rng = np.random.RandomState(seed)
    q = rng.uniform(0.0, 1e-3, st.q.shape)
    q[:, 0] *= 10.0
    w = rng.normal(0.0, 0.5, st.w.shape)
    delz = st.delz.numpy() * rng.uniform(0.98, 1.02, st.delz.shape)
    u, v = mt.halo.sync_vector_interfaces(st.u, st.v, kind="dgrid")
    return DycoreState.from_numpy({**st.to_numpy(), "q": q, "w": w, "delz": delz,
                                   "u": u.numpy(), "v": v.numpy()},
                                  device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module", params=[(1, 1), (2, 2)], ids=["1x1", "2x2"])
def restart(request, tmp_path_factory):
    layout = request.param
    tm = MetricTerms.generate(GridSpec(n_tile=12, npz=8, layout=layout))
    jm = JMetricTerms.generate(JGridSpec(n_tile=12, npz=8, layout=layout))
    path = str(tmp_path_factory.mktemp(f"restart_{layout[0]}x{layout[1]}"))
    state = synthesized_state(tm, seed=layout[0])
    written = chip_smoke.write_fortran_restart(path, state, tm)
    return dict(tm=tm, jm=jm, path=path, state=state, written=written)


def test_both_packages_load_the_same_state(restart):
    got = tfr.load_fortran_restart(restart["path"], restart["tm"], "cpu", torch.float64)
    want = jfr.load_fortran_restart(restart["path"], restart["jm"], jnp.float64)
    for name in FIELDS:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype == np.float64, name
        assert np.array_equal(g, w, equal_nan=True), name
    assert got.omga is None and want.omga is None


def test_prognostics_are_the_written_arrays(restart):
    got = tfr.load_fortran_restart(restart["path"], restart["tm"], "cpu", torch.float64)
    src = restart["state"]
    for name, (ys, xs) in WRITTEN.items():
        g, w = getattr(got, name).numpy(), getattr(src, name).numpy()
        sl = np.s_[..., H:w.shape[-2] - H, H:w.shape[-1] - H]
        assert np.array_equal(g[sl], w[sl]), name
    assert np.array_equal(got.q.numpy()[..., H:-H, H:-H], src.q.numpy()[..., H:-H, H:-H])
    # and what the files hold is what the writer says it wrote
    tiles = tfr._read_tiles(restart["path"], "fv_core.res", 6)
    assert np.array_equal(tiles["delp"], restart["written"]["delp"])
    # the ghosts were refreshed: positive layer thicknesses off the corners
    assert (got.delp.numpy()[..., H:-H, :] > 0).all()


def test_coupler_res_parse(restart):
    path = os.path.join(restart["path"], "coupler.res")
    c = tfr.read_coupler_res(path)
    assert c.calendar == 2
    assert c.start_time == (2016, 8, 1, 0, 0, 0)
    assert c.current_time == (2016, 8, 1, 0, 30, 0)
    j = jfr.read_coupler_res(path)
    assert (c.calendar, c.start_time, c.current_time) == (j.calendar, j.start_time,
                                                          j.current_time)
    assert tfr.coupler_elapsed_seconds(restart["path"]) == 1800.0


def test_surface_winds(restart):
    got = tfr.load_surface_winds(restart["path"], restart["tm"])
    want = jfr.load_surface_winds(restart["path"], restart["jm"])
    assert sorted(got) == sorted(want) == ["u_srf", "v_srf"]
    ua = restart["state"].ua.numpy()[:, -1]
    for k in got:
        assert np.array_equal(got[k], want[k]), k
    assert np.array_equal(got["u_srf"][:, H:-H, H:-H], ua[:, H:-H, H:-H])
    assert tfr.load_surface_winds(os.path.dirname(restart["path"]), restart["tm"]) is None


@pytest.mark.parametrize("kind", ["restart", "fortran_restart"])
def test_initialization_and_start_time(restart, kind):
    assert tfr.is_fortran_restart(restart["path"]) and jfr.is_fortran_restart(restart["path"])
    layout = list(restart["tm"].spec.layout)
    init = {"type": kind, "config": {"path": restart["path"]}}
    d = Driver(DriverConfig.from_dict({"nx_tile": 12, "nz": 8, "layout": layout,
                                       "precision": 64, "minutes": 0,
                                       "initialization": init}), device="cpu")
    # the state of the reader, which test_both_packages_load_the_same_state
    # holds to pace_tpu's
    want = tfr.load_fortran_restart(restart["path"], restart["tm"], "cpu", torch.float64)
    for name in FIELDS:
        assert torch.equal(getattr(d.state, name).nan_to_num(7.0),
                           getattr(want, name).nan_to_num(7.0)), name
    assert d.time_seconds == 1800.0
    init["config"]["start_time_seconds"] = 900.0
    d = Driver(DriverConfig.from_dict({"nx_tile": 12, "nz": 8, "layout": layout,
                                       "precision": 64, "minutes": 0,
                                       "initialization": init}), device="cpu")
    assert d.time_seconds == 900.0


def test_tracer_names_are_pace_tpu_s():
    assert tfr.FORTRAN_TRACER_NAMES == jfr.FORTRAN_TRACER_NAMES
    assert set(tfr.FORTRAN_TRACER_NAMES.values()) == set(TRACER_NAMES)
