"""Fortran namelists and the GEOS raw-array wrapper against pace_tpu's.

The namelist of ``tests/main/test_geos_wrapper.py`` parses to the same
groups and the same ``DynamicalCoreConfig``. One wrapper step is held to
``pace_tpu``'s recording of the same step, with no JAX run: a namelist that
spells out ``tests/data/savepoints/baroclinic_c12_nh.yaml``'s dycore
(C12, npz=6, float64, nonhydrostatic) builds that config, the host passes
the config's initial state as raw arrays with 7 tracers (the wrapper pads
them to the nine of the registry), and the wrapper returns the fields of
``FVDynamics-Out`` of the first step in ``ref_c12_nh.npz`` (recorded by
``pace_tpu``'s ``savepoint_cli generate``), each within 1e-12 of its scale on
the compute domain (for ``w`` and ``delz`` the scale a difference of
pressures near 1e5 Pa sets, as ``tests/test_torch_driver.py`` holds them).
Calling twice gives the same bits.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from pace_tpu.utils import namelist as jnml
from pace_tpu_torch import constants
from pace_tpu_torch.driver.config import DriverConfig
from pace_tpu_torch.models.fv3.geos_wrapper import GeosDycoreWrapper
from pace_tpu_torch.testing import SnapshotCheckpointer
from pace_tpu_torch.utils.namelist import Namelist, parse_f90nml

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "savepoints")
NML = """
&fv_core_nml
    npx = 13
    npy = 13
    npz = 6
    k_split = 1
    n_split = 2
    hydrostatic = .false.
    nord = 1
    d4_bg = 0.12
    dddmp = 0.2
    do_vort_damp = .true.
    vtdm4 = 0.06
    fill = .T.
    tau = 10.0
    rf_cutoff = 3.0d3
    hord_mt = 6
/
&other_nml
    some_key = 'hello'
    values = 1, 2, 3
/
"""
H = 3
#: baroclinic_c12_nh.yaml's dycore_config as a host model's namelist
GOLDEN_NML = """
&fv_core_nml
    npx = 13
    npy = 13
    npz = 6
    k_split = 1
    n_split = 3
    hydrostatic = .false.
    nord = 1
    d4_bg = 0.12
    d_con = 1.0
    kord_mt = 9
    kord_tm = -9
    kord_tr = 9
    kord_wz = 9
    tracer_dynamic_subcycle = .false.
/
"""



@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the C12 arrays gain nothing from more, and the
    other workers of a parallel test run hold the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_namelist_parse(tmp_path):
    nml = Namelist.from_f90nml(NML)
    assert nml.npz == 6
    assert nml.hydrostatic is False
    assert nml.fill is True
    assert nml.rf_cutoff == 3000.0
    assert nml.some_key == "hello"
    assert nml.values == [1, 2, 3]
    assert parse_f90nml(NML) == jnml.parse_f90nml(NML)
    assert set(parse_f90nml(NML)) == {"fv_core_nml", "other_nml"}
    path = tmp_path / "input.nml"
    path.write_text(NML)
    assert Namelist.from_f90nml(str(path)).groups == nml.groups
    assert nml.get("missing", 3) == 3
    with pytest.raises(AttributeError):
        nml.missing


def test_namelist_to_dycore_config():
    cfg = Namelist.from_f90nml(NML).dycore_config()
    assert cfg.npz == 6 and cfg.n_split == 2 and cfg.hydrostatic is False
    assert cfg.do_vort_damp is True and cfg.vtdm4 == 0.06
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jnml.Namelist.from_f90nml(NML).dycore_config())


@pytest.fixture(scope="module")
def stepped():
    cfg = DriverConfig.from_yaml(os.path.join(DATA, "baroclinic_c12_nh.yaml"))
    wrapper = GeosDycoreWrapper(Namelist.from_f90nml(GOLDEN_NML), n_tile=cfg.nx_tile,
                                npz=cfg.nz, bdt=cfg.dt_atmos, device="cpu",
                                dtype=torch.float64)
    start = cfg.initialization.get_dycore_state(wrapper.metric_terms, "cpu", torch.float64)
    raw = {k: v for k, v in start.to_numpy().items()
           if k in ("u", "v", "w", "delz", "pt", "delp", "ps", "pe", "pk", "peln", "pkz",
                    "phis")}
    raw["q"] = start.q.numpy()[:, :7]
    return dict(cfg=cfg, raw=raw, start=start, wrapper=wrapper, port=wrapper(**raw))


def test_wrapper_step_matches(stepped):
    cfg, wrapper, start = stepped["cfg"], stepped["wrapper"], stepped["start"]
    assert wrapper.config == cfg.dycore_config
    gold = SnapshotCheckpointer.load(os.path.join(DATA, "ref_c12_nh.npz"))
    # the recorded step starts from the state the host passed: the two
    # tracers it leaves out are zero there
    assert not start.q[:, 7:].any()
    for name, w in gold.data["FVDynamics-In"][0].items():
        assert np.array_equal(getattr(start, name).numpy(), w, equal_nan=True), name
    got = stepped["port"]
    assert set(got) >= {"u", "v", "w", "delp", "pt", "q", "delz", "ps", "ua", "va"}
    assert got["q"].shape[1] == len(constants.TRACER_NAMES)
    delp = stepped["raw"]["delp"][..., H:-H, H:-H]
    dt = cfg.dt_atmos / (cfg.dycore_config.k_split * cfg.dycore_config.n_split)
    p_err = ((float(delp.sum(axis=1).max()) + float(wrapper.grid.ptop)) * dt
             / (float(delp.min()) / constants.GRAV))
    scales = {"w": p_err, "delz": p_err * dt}
    want = gold.data["FVDynamics-Out"][0]
    assert sorted(want) == ["delp", "delz", "pt", "q", "u", "v", "w"]
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == np.float64, name
        sl = np.s_[..., H:g.shape[-2] - H, H:g.shape[-1] - H]
        g, w = g[sl], w[sl]
        assert np.isfinite(g).all(), name
        scale = max(float(np.abs(w).max()), scales.get(name, 0.0))
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12 * scale, err_msg=name)
    assert 10.0 < np.abs(got["u"][..., H:-H, H:-H]).max() < 100.0


def test_wrapper_is_deterministic(stepped):
    again = stepped["wrapper"](**stepped["raw"])
    assert all(np.array_equal(again[k], v) for k, v in stepped["port"].items())
