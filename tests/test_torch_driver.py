"""The port's driver against pace_tpu's on the CPU, float64: dycore runs.

Each configuration runs once in each package in a module-scoped fixture
(``Driver(cfg, device="cpu")`` on the port's side, ``pace_tpu``'s ``Driver``
on the JAX side, both with ``precision: 64``):

- ``tests/main/test_driver.py``'s ``short_run``: C12 nz=8, hydrostatic, 3
  steps of 300 s, ``ps`` and ``column_integrated_qvapor``, the final restart
  saved;
- ``examples/configs/baroclinic_c24_nonhydro.yaml`` cut to C12 nz=8 and 2
  steps.

For each run the final state agrees within 1e-12 of each field's scale on
the compute domain (its largest reference value, or for ``w``, ``delz`` and
``omga`` the scale a difference of pressures near 1e5 Pa sets, as
``tests/test_torch_dycore.py`` holds them), the diagnostics agree to one
float32 ulp, and the restart files hold the same dataset names, dtypes and
attributes. Then the restarts cross: ``pace_tpu``'s final restart, loaded by
the port's ``Driver`` through ``pace_tpu``'s ``restart.yaml`` and run one
step, agrees with ``pace_tpu``'s run going on for that step, and the port's,
loaded by ``pace_tpu``'s ``Driver`` through the port's ``restart.yaml``, with
the port's. Then the driver's refusals: no card without ``device="cpu"``, and
the parts that are not ported (the mesh and the halo backends of ROADMAP queue
1 item 7, with the three comm configs) raise ``NotImplementedError``. Last,
what queue 1 item 3 added: ``pair_debug`` (the replica equal to the model at
every stage of a step of ``baroclinic_c12.yaml``) and ``debug_checks``
build, and ``external_c12.yaml`` and
``baroclinic_c12_read_restart_fortran.yaml`` run a step on the CPU from files
the writers of ``chip_smoke.py`` make (``tropicalcyclone_c128.yaml`` and
``baroclinic_c12_from_savepoint.yaml`` run in
``tests/test_torch_tropical_cyclone.py`` and ``tests/test_torch_translate.py``).
"""

import copy
import dataclasses
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pace_tpu import constants as jconstants
from pace_tpu.driver.config import DriverConfig as JDriverConfig
from pace_tpu.driver.driver import Driver as JDriver
from pace_tpu_torch.driver.config import DriverConfig
from pace_tpu_torch.driver.driver import Driver
from pace_tpu_torch.models.fv3.state import DycoreState

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(ROOT, "examples", "configs")
H = 3
RTOL = 1e-12
STATE_FIELDS = ("u", "v", "w", "delz", "delp", "pt", "q", "ps", "pe", "peln", "pk", "pkz",
                "omga", "ua", "va", "uc", "vc", "mfxd", "mfyd", "cxd", "cyd")

SHORT_RUN = {
    "nx_tile": 12,
    "nz": 8,
    "layout": [1, 1],
    "dt_atmos": 300.0,
    "minutes": 15,
    "precision": 64,
    "dycore_config": {"k_split": 1, "n_split": 2, "hydrostatic": True},
    "diagnostics_config": {
        "output_frequency": 1,
        "names": ["ps"],
        "derived_names": ["column_integrated_qvapor"],
    },
    "restart_config": {"save_restart": True},
}


def yaml_config(name, nx_tile=12, nz=8, minutes=None):
    """An example config, read by PyYAML, cut to ``nx_tile``, ``nz`` and
    ``minutes``, in float64."""
    with open(os.path.join(CONFIG_DIR, name)) as f:
        raw = yaml.safe_load(f)
    raw.update(nx_tile=nx_tile, nz=nz, precision=64)
    if minutes is not None:
        raw.update(minutes=minutes, hours=0)
    return raw


def with_paths(raw, tmp):
    """``raw`` with its outputs under ``tmp``."""
    raw = copy.deepcopy(raw)
    raw.setdefault("diagnostics_config", {})["path"] = str(tmp / "output")
    raw.setdefault("performance_config", {})["experiment_name"] = str(tmp / "exp")
    raw.setdefault("restart_config", {})["path"] = str(tmp / "RESTART")
    return raw


def run_both(raw, tmp_path_factory, tag):
    """The config run by each package; returns {"jax": ..., "torch": ...}
    with each driver and its output directory."""
    out = {}
    for impl in ("jax", "torch"):
        tmp = tmp_path_factory.mktemp(f"{tag}_{impl}")
        cfg_raw = with_paths(raw, tmp)
        if impl == "jax":
            d = JDriver(JDriverConfig.from_dict(cfg_raw))
        else:
            d = Driver(DriverConfig.from_dict(cfg_raw), device="cpu")
        d.step_all()
        d.cleanup()
        out[impl] = dict(driver=d, tmp=tmp)
    return out


def pressure_scales(raw, delp0):
    """Scales of w, delz and omga: a difference of pressures near 1e5 Pa
    times the acoustic dt over the lightest layer's mass, that times dt, and
    the largest interface pressure over the outer step."""
    dyc = raw.get("dycore_config", {})
    k_split, n_split = dyc.get("k_split", 1), dyc.get("n_split", 1)
    delp = delp0[..., H:-H, H:-H]
    pe_max = float(delp.sum(axis=1).max()) + 300.0
    dt = raw["dt_atmos"] / (k_split * n_split)
    p_err = pe_max * dt / (float(delp.min()) / jconstants.GRAV)
    return {"w": p_err, "delz": p_err * dt, "omga": pe_max * k_split / raw["dt_atmos"]}


def region(shape, n=12):
    dy, dx = shape[-2] - (n + 2 * H), shape[-1] - (n + 2 * H)
    return np.s_[..., H:H + n + dy, H:H + n + dx]


def assert_state_close(got, want, scales, fields=STATE_FIELDS):
    for name in fields:
        w = getattr(want, name)
        g = getattr(got, name)
        if w is None:
            assert g is None, name
            continue
        w = np.asarray(w)
        g = g.detach().cpu().numpy()
        assert g.shape == w.shape, name
        r = region(w.shape)
        g, w = g[r], w[r]
        assert np.isfinite(g).all(), name
        scale = max(float(np.abs(w).max()), scales.get(name, 0.0))
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL * scale, err_msg=name)


def assert_f32_ulp(got, want, what):
    """float32 arrays equal to one ulp of the larger magnitude."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)))
    assert (np.abs(got.astype(np.float64) - want) <= ulp).all(), what


def h5_layout(path):
    """{dataset: (dtype, shape)} and the attributes of an HDF5 file."""
    with h5py.File(path, "r") as f:
        return ({k: (str(f[k].dtype), f[k].shape) for k in f},
                {k: f.attrs[k] for k in f.attrs})


@pytest.fixture(scope="module")
def short_run(tmp_path_factory):
    return run_both(SHORT_RUN, tmp_path_factory, "short")


@pytest.fixture(scope="module")
def nonhydro_run(tmp_path_factory):
    raw = yaml_config("baroclinic_c24_nonhydro.yaml", minutes=15)
    return dict(raw=raw, runs=run_both(raw, tmp_path_factory, "nonhydro"))


def test_short_run_state_matches(short_run):
    j, t = short_run["jax"]["driver"], short_run["torch"]["driver"]
    assert t._step_count == j._step_count == 3
    assert t.time_seconds == j.time_seconds == 900.0
    assert t.state.u.dtype == torch.float64 and t.state.u.device.type == "cpu"
    assert_state_close(t.state, j.state, {})


def test_short_run_diagnostics_match(short_run):
    paths = [short_run[i]["tmp"] / "output" / "diagnostics.h5" for i in ("jax", "torch")]
    assert h5_layout(paths[0]) == h5_layout(paths[1])
    with h5py.File(paths[0]) as fj, h5py.File(paths[1]) as ft:
        assert fj["ps"].shape[0] == 3
        for name in fj:
            assert_f32_ulp(ft[name][...], fj[name][...], name)


def test_short_run_restart_files_match(short_run):
    """The same files with the same datasets (name, dtype, shape) and
    attributes; restart.yaml read by PyYAML gives the same mapping but for
    the restart path."""
    dirs = [short_run[i]["tmp"] / "RESTART" for i in ("jax", "torch")]
    assert sorted(os.listdir(dirs[0])) == sorted(os.listdir(dirs[1])) == [
        "restart.yaml", "restart_dycore_state.h5"]
    (jsets, jattrs), (tsets, tattrs) = (h5_layout(d / "restart_dycore_state.h5") for d in dirs)
    assert jsets == tsets
    assert jattrs == tattrs == {"time_seconds": 900.0}
    raws = []
    for d in dirs:
        with open(d / "restart.yaml") as f:
            raw = yaml.safe_load(f)
        assert raw["initialization"]["config"]["path"] == str(d)
        raw["initialization"]["config"]["path"] = None
        for key in ("diagnostics_config", "performance_config", "restart_config"):
            raw[key] = {k: v for k, v in raw[key].items()
                        if k not in ("path", "experiment_name")}
        raws.append(raw)
    assert raws[0] == raws[1]


def _resume(impl, restart_dir, tmp):
    """One step from ``restart_dir``'s restart.yaml, read by ``impl``'s
    DriverConfig.from_yaml, with no outputs but the perf JSON in ``tmp``."""
    cls = JDriverConfig if impl == "jax" else DriverConfig
    cfg = cls.from_yaml(str(restart_dir / "restart.yaml"))
    assert cfg.initialization.type == "restart"
    assert cfg.n_timesteps == 3
    cfg = dataclasses.replace(
        cfg, minutes=5,
        diagnostics_config=dataclasses.replace(cfg.diagnostics_config, names=[],
                                               derived_names=[]),
        performance_config=dataclasses.replace(cfg.performance_config,
                                               experiment_name=str(tmp / impl)),
        restart_config=dataclasses.replace(cfg.restart_config, save_restart=False),
    )
    d = JDriver(cfg) if impl == "jax" else Driver(cfg, device="cpu")
    assert d.time_seconds == 900.0
    d.step_all()
    return d


RESUME_FIELDS = ("u", "v", "delp", "pt", "q", "ps", "pe", "peln", "pk", "pkz", "omga", "ua",
                 "va")


def test_port_resumes_pace_tpu_restart(short_run, tmp_path):
    """pace_tpu's final restart, resumed for one step by the port, agrees
    with pace_tpu's run going on for that step (the restart holds the state
    exactly in float64)."""
    j = short_run["jax"]["driver"]
    resumed = _resume("torch", short_run["jax"]["tmp"] / "RESTART", tmp_path)
    assert resumed.time_seconds == 1200.0
    # the JAX step donates its input: step a copy of the final state
    on = j.dycore.step_dynamics(jax.tree_util.tree_map(jnp.copy, j.state))
    assert_state_close(resumed.state, on, {}, RESUME_FIELDS)


def test_pace_tpu_resumes_port_restart(short_run, tmp_path):
    """The port's final restart, read by pace_tpu's DriverConfig (PyYAML)
    and Driver and resumed for one step, agrees with the port's run going
    on for that step."""
    t = short_run["torch"]["driver"]
    resumed = _resume("jax", short_run["torch"]["tmp"] / "RESTART", tmp_path)
    assert resumed.time_seconds == 1200.0
    on = t.dycore.step_dynamics(t.state)
    assert_state_close(on, resumed.state, {}, RESUME_FIELDS)


def test_nonhydro_run_state_matches(nonhydro_run):
    j, t = (nonhydro_run["runs"][i]["driver"] for i in ("jax", "torch"))
    assert t._step_count == j._step_count == 2
    assert not t.config.dycore_config.hydrostatic
    # the scales come from the initial state's layers
    init = DycoreState.from_baroclinic_init(t.metric_terms, device="cpu",
                                            dtype=torch.float64)
    scales = pressure_scales(nonhydro_run["raw"], init.delp.numpy())
    assert_state_close(t.state, j.state, scales)


def test_nonhydro_run_diagnostics_match(nonhydro_run):
    paths = [nonhydro_run["runs"][i]["tmp"] / "output" / "diagnostics.h5"
             for i in ("jax", "torch")]
    assert h5_layout(paths[0]) == h5_layout(paths[1])
    with h5py.File(paths[0]) as fj, h5py.File(paths[1]) as ft:
        assert sorted(fj) == ["lat", "lon", "ps", "time", "ua", "va"]
        for name in fj:
            assert_f32_ulp(ft[name][...], fj[name][...], name)


def test_driver_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Driver(DriverConfig.from_dict({"nx_tile": 12, "nz": 4}))


@pytest.mark.parametrize("override, item", [
    ({"mesh_config": {"enabled": True}}, "item 7"),
    ({"comm_config": {"type": "null"}}, "item 7"),
    ({"comm_config": {"type": "write"}}, "item 7"),
    ({"comm_config": {"type": "read"}}, "item 7"),
])
def test_unported_parts_raise(override, item):
    cfg = DriverConfig.from_dict({"nx_tile": 12, "nz": 4, **override})
    with pytest.raises(NotImplementedError, match=item):
        Driver(cfg, device="cpu")


@pytest.fixture
def one_thread():
    """One intra-op thread for the C12 runs of what queue 1 item 3 added:
    they gain nothing from more, and the other workers of a parallel test
    run hold the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["baroclinic_c12_null_comm.yaml", "baroclinic_c12_comm_read.yaml",
                                  "baroclinic_c12_comm_write.yaml"])
def test_comm_configs_raise_naming_item_7(name):
    raw = yaml_config(name, nz=4)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 7"):
        Driver(DriverConfig.from_dict(raw), device="cpu")


@pytest.mark.parametrize("override", [
    {"pair_debug": True},
    {"debug_checks": True},
    {"initialization": {"type": "tropicalcyclone"}},
    {"initialization": {"type": "analytic", "config": {"case": "tropicalcyclone"}}},
], ids=["pair_debug", "debug_checks", "tropicalcyclone", "analytic_tropicalcyclone"])
def test_item_3_parts_are_taken(override, one_thread):
    """What the driver refused until queue 1 item 3 was ported now builds."""
    d = Driver(DriverConfig.from_dict({"nx_tile": 12, "nz": 4, "minutes": 0, **override}),
               device="cpu")
    if "pair_debug" in override:
        assert d.dycore_pair is not None and d._pair_cmp.snapshot is d.dycore.checkpointer
    elif "debug_checks" in override:
        assert type(d.dycore.checkpointer).__name__ == "SanitizerCheckpointer"
    else:
        assert float(d.state.qvapor.max()) > 0.005 and d.dycore.checkpointer is None


def test_fortran_restart_directory_raises(tmp_path):
    """A directory with fv_core.res.nc is read as a Fortran restart: here
    its tile files are missing, and the Fortran reader says so."""
    (tmp_path / "fv_core.res.nc").write_bytes(b"")
    cfg = DriverConfig.from_dict({"nx_tile": 12, "nz": 4, "initialization": {
        "type": "restart", "config": {"path": str(tmp_path)}}})
    with pytest.raises(FileNotFoundError, match="fv_core.res.tile1.nc"):
        Driver(cfg, device="cpu")


def test_pair_debug_replicas_agree_at_every_stage(tmp_path, one_thread):
    raw = with_paths(yaml_config("baroclinic_c12.yaml", nz=4, minutes=0), tmp_path)
    raw.update(seconds=225, pair_debug=True)
    d = Driver(DriverConfig.from_dict(raw), device="cpu")
    d.step_all()
    d.cleanup()
    assert d._step_count == 1
    fired = {k: len(v) for k, v in d._pair_cmp.snapshot.data.items()}
    assert fired == d._pair_cmp._idx == {
        "FVDynamics-In": 1, "C_SW-In": 5, "C_SW-Out": 5, "D_SW-Out": 5, "Tracer2D1L-In": 1,
        "Tracer2D1L-Out": 1, "Remapping-In": 1, "Remapping-Out": 1, "FVDynamics-Out": 1}
    for f in dataclasses.fields(d.state):
        a, b = getattr(d.state, f.name), getattr(d.state_pair, f.name)
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b)), f.name


def test_external_config_runs(tmp_path, one_thread):
    """examples/configs/external_c12.yaml (layout [2, 2]) cut to nz=4 and
    one step, its tiles and eta file written beside it."""
    import chip_smoke
    from pace_tpu_torch.grid.eta import get_coefficients

    os.makedirs(tmp_path / "C12_grid")
    chip_smoke.write_fre_supergrid(str(tmp_path / "C12_grid" / "C12.tile{tile}.nc"), 12)
    eta = get_coefficients(4)
    chip_smoke.write_eta_file(str(tmp_path / "eta4.nc"), eta.ak, eta.bk)
    raw = with_paths(yaml_config("external_c12.yaml", nz=4, minutes=0), tmp_path)
    raw["seconds"] = raw["dt_atmos"]
    raw["grid_config"]["config"].update(tile_paths=str(tmp_path / "C12_grid/C12.tile{tile}.nc"),
                                        eta_file=str(tmp_path / "eta4.nc"))
    raw["diagnostics_config"].pop("z_select")
    d = Driver(DriverConfig.from_dict(raw), device="cpu")
    assert np.array_equal(d.metric_terms.ak, eta.ak) and d.metric_terms.halo.n_shards == 24
    d.step_all()
    d.cleanup()
    assert d._step_count == 1 and bool(torch.isfinite(d.state.u[..., H:-H, H:-H]).all())


def test_read_restart_fortran_config_runs(tmp_path, one_thread):
    """examples/configs/baroclinic_c12_read_restart_fortran.yaml cut to
    nz=8 and one step, from a restart the port's state wrote."""
    import chip_smoke
    from pace_tpu_torch.grid.generation import GridSpec, MetricTerms

    mt = MetricTerms.generate(GridSpec(n_tile=12, npz=8, layout=(1, 1)))
    src = DycoreState.from_analytic_init(mt, device="cpu", dtype=torch.float64)
    chip_smoke.write_fortran_restart(str(tmp_path / "restart_data"), src, mt)
    raw = with_paths(yaml_config("baroclinic_c12_read_restart_fortran.yaml", nz=8, minutes=0),
                     tmp_path)
    raw["seconds"] = raw["dt_atmos"]
    raw["initialization"]["config"]["path"] = str(tmp_path / "restart_data")
    d = Driver(DriverConfig.from_dict(raw), device="cpu")
    assert torch.equal(d.state.delp[..., H:-H, H:-H], src.delp[..., H:-H, H:-H])
    assert d.time_seconds == 1800.0
    d.step_all()
    d.cleanup()
    assert d._step_count == 1 and d.time_seconds == 1800.0 + raw["dt_atmos"]
    assert bool(torch.isfinite(d.state.u[..., H:-H, H:-H]).all())


def test_grid_indexing_raises():
    d = Driver(DriverConfig.from_dict({"nx_tile": 12, "nz": 4, "minutes": 0}), device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        d.grid_indexing()
