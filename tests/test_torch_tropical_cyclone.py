"""The tropical-cyclone initial state and the stretched grid against
pace_tpu's, on the CPU in float64.

- The analytic profiles of ``init_tropical_cyclone`` (``specific_humidity``,
  ``pressure``, ``virtual_temperature``, ``tangential_wind``,
  ``_height_of_pressure`` and its threaded form ``_heights_of_pressure``,
  ``_radius_and_azimuth``) on seeded inputs are bit for bit ``pace_tpu``'s.
- The Schmidt-stretched metric terms at C12, npz=8, stretch 3.0 centred at
  (180 E, 10 N), for layouts (1, 1) and (2, 2): every array within 1e-12 of
  its scale (they are bit-identical today).
- The TC state (``init_tropical_cyclone_state`` and
  ``DycoreState.from_analytic_init(case="tropicalcyclone")``) is equal.
- One driver step of ``examples/configs/tropicalcyclone_c128.yaml`` cut to
  C12, npz=8 and 150 s, in float64: ``Driver(cfg, device="cpu")`` against
  ``pace_tpu``'s (jitted) ``Driver``. Each field agrees within the larger of
  1e-12 of its scale and the port's own round-off sensitivity: how far the
  port's step moves that field when its initial state is perturbed by
  1e-13 (``testing.perturb``, seed 0; the same yardstick the golden
  savepoints' thresholds are calibrated with). The yardstick matters for
  the tracers: ``pace_tpu``'s jitted step differs from its own eager step by
  1.4e-11 of ``q``'s scale (a limiter at the 1e-11 stratospheric humidity
  floor of the vortex flips), while the port's step agrees with
  ``pace_tpu``'s eager step within 3e-16 of it (measured with the stage
  checkpointers; the eager step takes too long for this test).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pace_tpu.driver.config import DriverConfig as JDriverConfig
from pace_tpu.driver.driver import Driver as JDriver
from pace_tpu.grid.generation import GridSpec as JGridSpec
from pace_tpu.grid.generation import MetricTerms as JMetricTerms
from pace_tpu.models.fv3 import init_tropical_cyclone as jtc
from pace_tpu.models.fv3.state import DycoreState as JDycoreState
from pace_tpu_torch.driver.config import DriverConfig
from pace_tpu_torch.driver.driver import Driver
from pace_tpu_torch.grid.generation import GridSpec, MetricTerms
from pace_tpu_torch.models.fv3 import init_tropical_cyclone as ttc
from pace_tpu_torch.models.fv3.state import DycoreState
from pace_tpu_torch.testing.perturb import perturb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TC_YAML = os.path.join(ROOT, "examples", "configs", "tropicalcyclone_c128.yaml")
H = 3
RTOL = 1e-12
STRETCH = dict(stretch_factor=3.0, lon_target=180.0, lat_target=10.0)
STATE_FIELDS = ("u", "v", "w", "delz", "delp", "pt", "q", "ps", "pe", "peln", "pk", "pkz",
                "omga", "ua", "va", "uc", "vc", "mfxd", "mfyd", "cxd", "cyd")
METRIC_FIELDS = ("lon", "lat", "lon_agrid", "lat_agrid", "xyz_corner", "xyz_center", "xyz_u",
                 "xyz_v", "dx", "dy", "dxa", "dya", "dxc", "dyc", "area", "area_c", "cos_sg",
                 "sin_sg", "cosa", "sina", "cosa_u", "sina_u", "cosa_v", "sina_v", "cosa_s",
                 "rsin2", "ec1", "ec2", "ew1", "ew2", "es1", "es2", "elon_u", "elat_u",
                 "elon_v", "elat_v", "elon_a", "elat_a", "f0", "fC", "ak", "bk", "rarea",
                 "rarea_c", "rdx", "rdy", "rdxa", "rdya", "rdxc", "rdyc", "rsina", "rsin_u",
                 "rsin_v")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the C12 arrays gain nothing from more, and the
    other workers of a parallel test run hold the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_profiles_are_pace_tpu_s():
    rng = np.random.RandomState(7)
    r = rng.uniform(0.0, 3.0e6, (4, 50))
    z = rng.uniform(0.0, 2.0e4, (4, 50))
    for name in ("pressure", "virtual_temperature", "tangential_wind"):
        assert np.array_equal(getattr(ttc, name)(r, z), getattr(jtc, name)(r, z)), name
    assert np.array_equal(ttc.specific_humidity(z), jtc.specific_humidity(z))
    p = rng.uniform(5.0e3, 1.0e5, (4, 50))
    zt = ttc._height_of_pressure(r, p)
    assert np.array_equal(zt, jtc._height_of_pressure(r, p))
    # the Newton iteration converged: the profile's pressure at the height
    assert np.allclose(ttc.pressure(r, zt), p, rtol=1e-10)
    # split over threads by shard, as the state is built: the same bits
    r3 = np.broadcast_to(r[:, None, :], (4, 3, 50))
    p3 = rng.uniform(5.0e3, 1.0e5, (4, 3, 50))
    assert np.array_equal(ttc._heights_of_pressure(r3, p3), jtc._height_of_pressure(r3, p3))
    lon = rng.uniform(0.0, 2 * np.pi, 200)
    lat = rng.uniform(-1.5, 1.5, 200)
    for a, b in zip(ttc._radius_and_azimuth(lon, lat), jtc._radius_and_azimuth(lon, lat)):
        assert np.array_equal(a, b)
    assert ttc._background() == jtc._background()


@pytest.mark.parametrize("layout", [(1, 1), (2, 2)])
def test_stretched_metric_terms_match(layout):
    spec = dict(n_tile=12, npz=8, layout=layout, **STRETCH)
    got = MetricTerms.generate(GridSpec(**spec))
    want = JMetricTerms.generate(JGridSpec(**spec))
    for name in METRIC_FIELDS:
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=RTOL * scale, err_msg=name)
    # the stretch moved resolution toward the target: the cells at the
    # target are smaller than those at its antipode
    unstretched = MetricTerms.generate(GridSpec(n_tile=12, npz=8, layout=layout))
    assert got.area.min() < 0.5 * unstretched.area.min()
    assert got.area.max() > 2.0 * unstretched.area.max()


@pytest.fixture(scope="module")
def stretched():
    spec = dict(n_tile=12, npz=8, layout=(1, 1), **STRETCH)
    return MetricTerms.generate(GridSpec(**spec)), JMetricTerms.generate(JGridSpec(**spec))


def test_tc_state_matches(stretched):
    tm, jm = stretched
    got, want = ttc.init_tropical_cyclone_state(tm), jtc.init_tropical_cyclone_state(jm)
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    ts = DycoreState.from_analytic_init(tm, case="tropicalcyclone", device="cpu",
                                        dtype=torch.float64)
    js = JDycoreState.from_analytic_init(jm, case="tropicalcyclone", dtype=jnp.float64)
    for name in STATE_FIELDS:
        w = getattr(js, name)
        if w is None:
            assert getattr(ts, name) is None, name
            continue
        assert np.array_equal(getattr(ts, name).numpy(), np.asarray(w)), name
    # tests/main/test_tropical_cyclone.py's physical checks, on the port's state
    ps = ts.ps.numpy()[:, H:-H, H:-H]
    qv = ts.qvapor.numpy()[..., H:-H, H:-H]
    assert ps.min() < ttc.P00 - 300.0 and ps.max() <= ttc.P00 + 1.0
    assert 5.0 < float(ts.u[..., H:-H, H:-H].abs().max()) < 60.0
    assert 0.01 < qv[:, -1].max() <= ttc.Q0 + 1e-6 and qv[:, 0].max() < 1e-4


def tc_config(tmp):
    with open(TC_YAML) as f:
        raw = yaml.safe_load(f)
    raw.update(nx_tile=12, nz=8, precision=64, minutes=0, seconds=150)
    raw["diagnostics_config"]["path"] = str(tmp / "output")
    raw["performance_config"]["experiment_name"] = str(tmp / "tc")
    return raw


@pytest.fixture(scope="module")
def jax_driver(tmp_path_factory):
    """pace_tpu's Driver of the cut config, its jitted step traced and
    lowered at the state's shapes (XLA has not compiled it yet)."""
    d = JDriver(JDriverConfig.from_dict(tc_config(tmp_path_factory.mktemp("tc_jax"))))
    return d, d.dycore._step.lower(d.state, d.dycore.grid)


@pytest.fixture(scope="module")
def jax_step(jax_driver):
    d, lowered = jax_driver
    lowered.compile()  # jit's cache now holds the executable step_all calls
    d.step_all()
    d.cleanup()
    return d


def test_pace_tpu_tc_step_is_lowered_in_float64(jax_driver):
    """The reference step is pace_tpu's jitted dycore step at the cut
    config's shapes in float64."""
    d, lowered = jax_driver
    assert np.asarray(d.state.u).shape == (6, 8, 19, 18)
    assert "tensor<6x8x19x18xf64>" in lowered.as_text()


def test_pace_tpu_tc_step_is_physical(jax_step):
    """The reference step this file holds the port to: one finite step that
    keeps the vortex (and that took the stretched grid and the config's
    damping)."""
    d = jax_step
    assert d._step_count == 1
    ps = np.asarray(d.state.ps)[:, H:-H, H:-H]
    assert np.isfinite(ps).all() and ps.min() < jtc.P00 - 300.0
    assert 5.0 < np.abs(np.asarray(d.state.u)[..., H:-H, H:-H]).max() < 60.0


def test_tc_driver_step_matches(jax_step, tmp_path):
    jd = jax_step
    d = Driver(DriverConfig.from_dict(tc_config(tmp_path / "port")), device="cpu")
    init = d.state
    d.step_all()
    d.cleanup()
    assert d._step_count == 1 and d.time_seconds == 150.0
    # the port's round-off sensitivity: its own step from a perturbed start
    bumped = d.dycore.step_dynamics(perturb(init, 1.0e-13, seed=0))
    sl = np.s_[..., H:-H, H:-H]
    for name in STATE_FIELDS:
        w = getattr(jd.state, name)
        g = getattr(d.state, name)
        if w is None:
            assert g is None, name
            continue
        w = np.asarray(w)[sl]
        g = g.numpy()[sl]
        assert g.shape == w.shape and np.isfinite(g).all(), name
        sens = float(np.abs(getattr(bumped, name).numpy()[sl] - g).max())
        tol = max(RTOL * float(np.abs(w).max()), sens)
        assert float(np.abs(g - w).max()) <= tol, name
