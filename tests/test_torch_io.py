"""The port's configuration reader, utilities and IO against pace_tpu's.

- The YAML subset reader (``pace_tpu_torch.utils.yaml_subset``) gives the
  same object as PyYAML's ``safe_load`` for every example config and for
  scalars of every YAML 1.1 kind; PyYAML is the oracle and only this test
  imports it. ``DriverConfig.from_yaml`` gives the same
  ``dataclasses.asdict`` and step count as ``pace_tpu``'s for every example
  config, with the same strictness; ``write_for_restart`` round-trips in
  both directions (PyYAML reads the port's ``restart.yaml``, the port reads
  ``pace_tpu``'s).
- IO: ``netcdf3.write`` of both packages gives byte-identical files for the
  same variables, with the native IO core and without it, and each package
  reads the other's files; ``zarr_v2`` groups are byte-identical;
  ``DycoreState.to_netcdf`` of the same state is byte-identical and
  ``as_dataset`` the same.
- The cases of ``tests/main/test_registry.py``, ``test_filesystem.py``,
  ``test_native_io.py``, ``test_diagnostics_formats.py`` and
  ``test_stage_profile.py`` (its synthetic events) against the port; the
  stage ranges of a step and of a physics call; the safety checker; the
  surface restart's dataset names against ``jax.tree_util.keystr``.
"""

import dataclasses
import glob
import json
import os
import subprocess
import sys
from types import SimpleNamespace
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pace_tpu.driver import safety_checks as jsafety
from pace_tpu.driver.config import DriverConfig as JDriverConfig
from pace_tpu.grid.generation import GridSpec as JGridSpec
from pace_tpu.grid.generation import MetricTerms as JMetricTerms
from pace_tpu.models.fv3 import state as jstate_mod
from pace_tpu.models.shield import surface as jsurface
from pace_tpu.utils import logging as jlogging
from pace_tpu.utils import netcdf3 as jnetcdf3
from pace_tpu.utils import registry as jreg
from pace_tpu.utils import zarr_v2 as jzarr
from pace_tpu_torch.driver import stage_profile
from pace_tpu_torch.driver.config import DriverConfig
from pace_tpu_torch.driver.driver import Driver
from pace_tpu_torch.driver.performance import get_sypd
from pace_tpu_torch.driver.restart import surface_leaves
from pace_tpu_torch.driver.safety_checks import SafetyChecker
from pace_tpu_torch.grid.generation import GridSpec, MetricTerms
from pace_tpu_torch.grid.grid_data import GridData
from pace_tpu_torch.models.fv3 import state as state_mod
from pace_tpu_torch.models.fv3.dycore import DynamicalCore, DynamicalCoreConfig
from pace_tpu_torch.models.fv3.state import DycoreState
from pace_tpu_torch.models.shield import surface as tsurface
from pace_tpu_torch.utils import filesystem, native, netcdf3, yaml_subset, zarr_v2
from pace_tpu_torch.utils import logging as tlogging
from pace_tpu_torch.utils.ranges import stage_range
from pace_tpu_torch.utils.registry import ConfigError, Registry, from_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "examples", "configs", "*.yaml")))
CONFIG_IDS = [os.path.basename(p)[:-5] for p in CONFIGS]


# ---------------------------------------------------------------------------
# the YAML subset and DriverConfig
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("path", CONFIGS, ids=CONFIG_IDS)
def test_yaml_reader_matches_pyyaml_on_example_configs(path):
    text = open(path).read()
    assert yaml_subset.load(text) == yaml.safe_load(text)


SCALARS = [
    "1e5", "1.0e5", "1.0e+5", "-1.5E+3", ".5", "3.", "1.e-3", "+12", "-0", "1_000", "0b101",
    "0x1F", "017", "08", "1:30", "1:30.5", ".inf", "-.Inf", "yes", "No", "ON", "off", "True",
    "FALSE", "~", "null", "NULL", "", '"null"', "'yes'", "'it''s'", '"a\\tb\\u0041"',
    "./C12_grid/C12.tile{tile}.nc", "http://x", "[1, 2.0, [x, y], {k: v, z: }]", "{}", "[]",
    "a b", "output_c192",
]


@pytest.mark.parametrize("text", SCALARS)
def test_yaml_scalars_resolve_as_pyyaml(text):
    assert yaml_subset.load(f"key: {text}") == yaml.safe_load(f"key: {text}")


def test_yaml_nan_and_block_forms():
    assert np.isnan(yaml_subset.load("a: .nan")["a"])
    text = ("a:\n- 1\n- b: 2\n  c: [3,\n    4]\n- - x\n  - y\n-\n  k: v\n"
            "d: {e: 1} # comment\n# only a comment\nf: 'g # h'\n")
    assert yaml_subset.load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["a: &x 1", "a: *x", "a: !tag 1", "a: |\n  x", "a: 2001-12-14",
                                  "a: b\n  c", "--- 1\n--- 2"])
def test_yaml_outside_the_subset_raises(text):
    with pytest.raises(yaml_subset.YAMLSubsetError):
        yaml_subset.load(text)


def test_yaml_dump_reads_back_in_both_readers():
    obj = {"a": [1, 2], "b": {"c": None, "d": "null", "e": "yes", "f": 1e-6, "g": 1e20,
                              "h": [], "i": {}, "j": [{"x": 1, "y": [1, [2, 3]]}], "k": "it's",
                              "m": "1e5", "n": "./x/{tile}.nc", "o": "", "p": float("inf"),
                              "q": True, "r": "~", "s": "-x", "t": "a:b", "u": "#x"}}
    text = yaml_subset.dump(obj)
    assert yaml.safe_load(text) == yaml_subset.load(text) == obj


def _asdict(cfg):
    raw = dataclasses.asdict(cfg)
    return json.loads(json.dumps(raw, default=str))


@pytest.mark.parametrize("path", CONFIGS, ids=CONFIG_IDS)
def test_driver_config_matches_pace_tpu(path):
    got, want = DriverConfig.from_yaml(path), JDriverConfig.from_yaml(path)
    assert _asdict(got) == _asdict(want)
    assert got.n_timesteps == want.n_timesteps > 0


@pytest.mark.parametrize("key", ["npx", "npy", "npz", "ntiles", "layout", "dt_atmos"])
def test_forbidden_derived_keys(key):
    with pytest.raises(ConfigError) as got:
        DriverConfig.from_dict({"dycore_config": {key: 10}})
    with pytest.raises(jreg.ConfigError) as want:
        JDriverConfig.from_dict({"dycore_config": {key: 10}})
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("data", [{"bogus": 1}, {"dycore_config": {"bogus": 1}},
                                  {"diagnostics_config": {"names": "ps", "nope": 2}},
                                  {"nx_tile": "twelve"}])
def test_driver_config_is_strict_like_pace_tpu(data):
    with pytest.raises(ConfigError) as got:
        DriverConfig.from_dict(data)
    with pytest.raises(jreg.ConfigError) as want:
        JDriverConfig.from_dict(data)
    assert str(got.value) == str(want.value)


def test_n_timesteps_and_sypd():
    cfg = DriverConfig.from_dict({"dt_atmos": 225.0, "hours": 1, "minutes": 15})
    assert cfg.n_timesteps == 20
    # 365 simulated days in one wall day: dt_atmos seconds per dt_atmos wall
    assert abs(get_sypd(225.0, 225.0) - 1.0 / 365.0) < 1e-12
    assert get_sypd(0.0, 225.0) == float("inf")


@pytest.mark.parametrize("name", ["baroclinic_c12", "baroclinic_c192", "earthlike_c24",
                                  "aquaplanet_c24", "external_c12"])
def test_write_for_restart_round_trips_both_ways(name, tmp_path):
    path = os.path.join(ROOT, "examples", "configs", f"{name}.yaml")
    for impl, cls in (("torch", DriverConfig), ("jax", JDriverConfig)):
        d = tmp_path / impl
        d.mkdir()
        cls.from_yaml(path).write_for_restart(str(d), 900.0)
        text = (d / "restart.yaml").read_text()
        assert yaml_subset.load(text) == yaml.safe_load(text), impl
        got, want = (DriverConfig.from_yaml(str(d / "restart.yaml")),
                     JDriverConfig.from_yaml(str(d / "restart.yaml")))
        assert _asdict(got) == _asdict(want), impl
        assert got.initialization.type == "restart"
        assert got.initialization.config == {"path": str(d), "start_time_seconds": 900.0}


# ---------------------------------------------------------------------------
# registry, filesystem, logging (tests/main/test_registry.py, test_filesystem.py)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Inner:
    a: int = 1
    b: float = 2.0


@dataclasses.dataclass
class Outer:
    name: str
    inner: Inner = dataclasses.field(default_factory=Inner)
    layout: Tuple[int, int] = (1, 1)
    maybe: Optional[Inner] = None


def test_from_dict_nested():
    out = from_dict(Outer, {"name": "x", "inner": {"a": 5}, "layout": [2, 3]})
    assert out.inner.a == 5 and out.inner.b == 2.0
    assert out.layout == (2, 3)
    assert out.maybe is None


def test_from_dict_strict_unknown_key():
    with pytest.raises(ConfigError):
        from_dict(Outer, {"name": "x", "bogus": 1})


def test_from_dict_int_to_float_cast():
    assert isinstance(from_dict(Inner, {"b": 3}).b, float)


@pytest.mark.parametrize("cls", [Registry, jreg.Registry], ids=["torch", "jax"])
def test_registry_roundtrip(cls):
    registry = cls()

    @registry.register("analytic")
    @dataclasses.dataclass
    class AnalyticInit:
        case: str = "baroclinic"

    obj = registry.from_dict({"type": "analytic", "config": {"case": "tropicalcyclone"}})
    assert obj.case == "tropicalcyclone"
    assert list(registry.registered_types) == ["analytic"]
    with pytest.raises(ValueError) as err:
        registry.from_dict({"type": "nope"})
    assert str(err.value) == "unknown type 'nope'; registered: ['analytic']"


def test_registry_default_type():
    registry = Registry(default_type="plain")

    @registry.register("plain")
    @dataclasses.dataclass
    class Plain:
        x: int = 0

    assert registry.from_dict({}).x == 0
    with pytest.raises(ConfigError, match="no 'type' key"):
        Registry().from_dict({})


def test_filesystem_local_roundtrip(tmp_path):
    p = str(tmp_path / "sub" / "dir")
    fs = filesystem.get_fs(p)
    fs.makedirs(p, exist_ok=True)
    assert fs.isdir(p)
    fpath = os.path.join(p, "x.bin")
    with fs.open(fpath, "wb") as f:
        f.write(b"abc")
    with filesystem.open_file(fpath, "rb") as f:
        assert f.read() == b"abc"
    assert filesystem.is_file(fpath)
    assert fpath in fs.ls(p)


def test_filesystem_local_shim(tmp_path):
    p = str(tmp_path)
    shim = filesystem._LOCAL
    shim.makedirs(os.path.join(p, "a"), exist_ok=True)
    assert shim.exists(os.path.join(p, "a"))
    assert shim.glob(os.path.join(p, "*")) == [os.path.join(p, "a")]
    shim.rm(os.path.join(p, "a"), recursive=True)
    assert not shim.exists(os.path.join(p, "a"))


def test_logging_levels_are_pace_tpu_s():
    assert tlogging.AVAILABLE_LOG_LEVELS == jlogging.AVAILABLE_LOG_LEVELS
    log = tlogging.get_logger()
    old = log.level
    try:
        tlogging.set_log_level("WARNING")
        assert log.level == tlogging.AVAILABLE_LOG_LEVELS["warning"]
    finally:
        log.setLevel(old)


# ---------------------------------------------------------------------------
# native IO and NetCDF-3 (tests/main/test_native_io.py)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def lib():
    l = native.lib()
    assert l is not None, "the native IO core did not build (g++)"
    return l


def test_to_native_endian_matches_numpy(lib):
    rng = np.random.default_rng(0)
    for dt in (">f4", ">f8", ">i2", ">i4", ">i1"):
        a = rng.standard_normal(100_003).astype(dt)
        got = native.to_native_endian(a)
        np.testing.assert_array_equal(got, a.astype(np.dtype(dt).newbyteorder("=")))


def test_to_native_endian_large_parallel_path(lib):
    # more than 1M elements crosses the multithreaded cutoff of nc3core.cpp
    a = (np.arange(3_000_000, dtype=np.float64) * 1.5).astype(">f8")
    np.testing.assert_array_equal(native.to_native_endian(a), a.astype("=f8"))


def test_swap_write_read_roundtrip(lib, tmp_path):
    p = tmp_path / "raw.bin"
    a = np.arange(50_000, dtype=np.float32) / 7.0
    fd = os.open(p, os.O_RDWR | os.O_CREAT)
    try:
        assert native.swap_write(fd, 16, a, ">f4") == a.nbytes
        back = native.swap_read(fd, 16, a.size, ">f4")
    finally:
        os.close(fd)
    np.testing.assert_array_equal(back, a)
    np.testing.assert_array_equal(np.fromfile(p, dtype=">f4", offset=16).astype("=f4"), a)


#: writes the same variables with both packages' netcdf3 into ``out``; run
#: here and in a subprocess without the native core
_WRITE_BOTH = r"""
import numpy as np
from pace_tpu.utils import netcdf3 as J
from pace_tpu_torch.utils import netcdf3 as T

def variables(m):
    rng = np.random.default_rng(7)
    return dict(
        dims={"time": None, "z": 4, "y": 6, "x": 6, "big": 300_000},
        variables={
            "pt": m.Variable(dims=("time", "z", "y", "x"),
                             data=rng.standard_normal((3, 4, 6, 6)).astype(np.float32),
                             attrs={"units": "K", "scale": np.float64(1.5)}),
            "ps": m.Variable(dims=("time", "y", "x"),
                             data=rng.standard_normal((3, 6, 6))),
            "phis": m.Variable(dims=("y", "x"), data=rng.standard_normal((6, 6))),
            "kidx": m.Variable(dims=("z",), data=np.arange(4, dtype=np.int32)),
            "big": m.Variable(dims=("big",), data=rng.standard_normal(300_000)),
        },
        attrs={"title": "roundtrip"},
    )

for name, m in (("jax", J), ("torch", T)):
    m.write(f"{OUT}/{name}{TAG}.nc", m.NetCDF3File(**variables(m)))
"""


def _write_both(out, tag, disable_native):
    code = f"OUT = {str(out)!r}\nTAG = {tag!r}\n" + _WRITE_BOTH
    if not disable_native:
        exec(compile(code, "write_both", "exec"), {})
        return
    env = dict(os.environ, PACE_TPU_DISABLE_NATIVE="1", JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=300)


def test_netcdf3_files_are_byte_identical_to_pace_tpu_s(lib, tmp_path):
    """The same variables give the same bytes from both packages, with the
    native IO core and without it (numpy only, in a subprocess), and each
    package reads the other's file."""
    _write_both(tmp_path, "_native", disable_native=False)
    _write_both(tmp_path, "_numpy", disable_native=True)
    files = {n: (tmp_path / n).read_bytes() for n in
             ("jax_native.nc", "torch_native.nc", "jax_numpy.nc", "torch_numpy.nc")}
    assert len(set(files.values())) == 1
    for reader, writer in ((netcdf3, "jax"), (jnetcdf3, "torch")):
        back = reader.read(str(tmp_path / f"{writer}_native.nc"))
        assert back.dims == {"time": None, "z": 4, "y": 6, "x": 6, "big": 300_000}
        assert back.numrecs == 3 and back.attrs["title"] == "roundtrip"
        assert back.variables["pt"].attrs["units"] == "K"
        assert back.variables["pt"].data.shape == (3, 4, 6, 6)
        assert np.asarray(back.variables["big"].data).dtype.isnative


def test_netcdf3_write_simple_matches(tmp_path):
    arrays = {"a": np.arange(12.0).reshape(3, 4), "b": np.arange(5, dtype=np.int32)}
    netcdf3.write_simple(str(tmp_path / "t.nc"), arrays, attrs={"x": "y"})
    jnetcdf3.write_simple(str(tmp_path / "j.nc"), arrays, attrs={"x": "y"})
    assert (tmp_path / "t.nc").read_bytes() == (tmp_path / "j.nc").read_bytes()


# ---------------------------------------------------------------------------
# zarr v2 and the state's dataset export
# ---------------------------------------------------------------------------
def _tree_bytes(root):
    return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
            for d, _dirs, files in os.walk(root) for f in files}


def test_zarr_groups_are_byte_identical(tmp_path):
    rng = np.random.default_rng(3)
    recs = rng.standard_normal((3, 6, 5, 4))
    for name, m in (("jax", jzarr), ("torch", zarr_v2)):
        g = m.ZarrGroup(str(tmp_path / name))
        g.write_constant("lat", recs[0, :, :, 0])
        for it in range(3):
            g.append_time("ps", it, recs[it])
    assert _tree_bytes(tmp_path / "jax") == _tree_bytes(tmp_path / "torch")
    for m in (jzarr, zarr_v2):
        back = m.read_array(str(tmp_path / "torch" / "ps"))
        np.testing.assert_array_equal(back, recs.astype(np.float32))


@pytest.fixture(scope="module")
def init_states():
    jmt = JMetricTerms.generate(JGridSpec(n_tile=12, npz=4, layout=(1, 1)))
    mt = MetricTerms.generate(GridSpec(n_tile=12, npz=4, layout=(1, 1)))
    jst = jstate_mod.DycoreState.from_analytic_init(jmt, case="baroclinic", dtype=jnp.float64)
    tst = DycoreState.from_analytic_init(mt, case="baroclinic", device="cpu",
                                         dtype=torch.float64)
    return dict(jmt=jmt, mt=mt, jst=jst, tst=tst)


def test_from_analytic_init_is_the_baroclinic_state(init_states):
    mt, tst = init_states["mt"], init_states["tst"]
    moist = DycoreState.from_baroclinic_init(mt, moist=True, device="cpu", dtype=torch.float64)
    for f in dataclasses.fields(tst):
        a, b = getattr(tst, f.name), getattr(moist, f.name)
        assert (a is None and b is None) or torch.equal(a, b), f.name
    assert not tst.q.any()
    # the tropical cyclone, once refused, is its own moist state
    # (held against pace_tpu's in tests/test_torch_tropical_cyclone.py)
    tc = DycoreState.from_analytic_init(mt, case="tropicalcyclone", device="cpu")
    assert float(tc.qvapor.max()) > 0.0 and not torch.equal(tc.u, tst.u.float())
    with pytest.raises(ValueError, match="unknown analytic init case"):
        DycoreState.from_analytic_init(mt, case="nope", device="cpu")


def test_as_dataset_matches(init_states):
    got = state_mod.as_dataset(init_states["tst"])
    want = jstate_mod.as_dataset(init_states["jst"])
    assert list(got) == list(want)
    for name in want:
        assert got[name]["dims"] == want[name]["dims"], name
        assert got[name]["units"] == want[name]["units"], name
        np.testing.assert_array_equal(got[name]["data"], np.asarray(want[name]["data"]))


def test_to_netcdf_is_byte_identical(init_states, tmp_path):
    state_mod.to_netcdf(init_states["tst"], str(tmp_path / "t.nc"))
    jstate_mod.to_netcdf(init_states["jst"], str(tmp_path / "j.nc"))
    assert (tmp_path / "t.nc").read_bytes() == (tmp_path / "j.nc").read_bytes()


# ---------------------------------------------------------------------------
# diagnostics stores (tests/main/test_diagnostics_formats.py)
# ---------------------------------------------------------------------------
def _run(tmp_path, fmt):
    out = str(tmp_path / f"out_{fmt}")
    cfg = DriverConfig.from_dict(dict(
        nx_tile=12, nz=4, layout=[1, 1], dt_atmos=60.0, minutes=2,
        dycore_config={"k_split": 1, "n_split": 1, "hydrostatic": True},
        diagnostics_config={
            "path": out, "output_frequency": 1, "names": ["ps"],
            "derived_names": ["column_integrated_qvapor"],
            "z_select": [{"level": 2, "names": ["pt"]}], "output_format": fmt,
        },
        performance_config={"experiment_name": str(tmp_path / "exp")},
        safety_checks=[],
    ))
    d = Driver(cfg, device="cpu")
    d.step_all()
    d.cleanup()
    return out


def test_zarr_output(tmp_path):
    out = _run(tmp_path, "zarr")
    ps = zarr_v2.read_array(os.path.join(out, "ps"))
    assert ps.shape == (2, 6, 12, 12)
    assert np.isfinite(ps).all() and 9e4 < ps.mean() < 1.1e5
    assert zarr_v2.read_array(os.path.join(out, "lat")).shape == (6, 12, 12)
    assert zarr_v2.read_array(os.path.join(out, "column_integrated_qvapor")).shape == (
        2, 6, 12, 12)
    assert zarr_v2.read_array(os.path.join(out, "pt_z2")).shape == (2, 6, 12, 12)
    meta = json.load(open(os.path.join(out, "ps", ".zarray")))
    assert meta["zarr_format"] == 2 and meta["compressor"] is None


def test_netcdf_output(tmp_path):
    out = _run(tmp_path, "netcdf")
    f = jnetcdf3.read(os.path.join(out, "diagnostics.nc"))  # pace_tpu reads it
    ps = np.asarray(f.variables["ps"].data)
    assert ps.shape == (2, 6, 12, 12) and np.isfinite(ps).all()
    assert "time" in f.variables and "pt_z2" in f.variables


def test_bad_format_raises(tmp_path):
    with pytest.raises(ValueError, match="output_format"):
        _run(tmp_path, "csv")


def test_profile_dir_writes_a_trace(tmp_path):
    """``profile_dir`` writes a TensorBoard-readable torch.profiler trace of
    the mainloop, where pace_tpu writes a jax.profiler trace."""
    cfg = DriverConfig.from_dict(dict(
        nx_tile=12, nz=4, dt_atmos=60.0, minutes=1,
        dycore_config={"k_split": 1, "n_split": 1, "hydrostatic": True},
        performance_config={"experiment_name": str(tmp_path / "exp"),
                            "profile_dir": str(tmp_path / "trace")},
    ))
    d = Driver(cfg, device="cpu")
    d.step_all()
    traces = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.load(open(traces[0]))["traceEvents"]}
    assert {"DynCore", "TracerAdvection", "Remapping"} <= names


# ---------------------------------------------------------------------------
# stage profile (tests/main/test_stage_profile.py) and the stage ranges
# ---------------------------------------------------------------------------
def test_attribute_stages_synthetic():
    kernels = [
        (1000.0, ("DynCore",)),
        (500.0, ("DynCore", "C_SW")),
        (2000.0, ("TracerAdvection",)),
        (3000.0, ("Remapping",)),
        (100.0, ()),
        (250.0, ("DynCore", "HaloExchange")),
    ]
    agg = stage_profile.attribute_stages(kernels)
    assert abs(agg["DynCore"] - 1.75e-3) < 1e-12
    assert abs(agg["TracerAdvection"] - 2e-3) < 1e-12
    assert abs(agg["Remapping"] - 3e-3) < 1e-12
    assert abs(agg["other"] - 1e-4) < 1e-12
    # HaloExchange, the innermost range, takes its kernels when asked for
    agg = stage_profile.attribute_stages(kernels, ("HaloExchange",) + stage_profile.STAGES)
    assert abs(agg["HaloExchange"] - 2.5e-4) < 1e-12
    assert abs(agg["DynCore"] - 1.5e-3) < 1e-12
    # no device event at all: the CPU
    assert stage_profile.attribute_stages([]) == {}


def _event(name, start, end, device="cpu", id_=0, annotation=False):
    from torch.autograd import DeviceType

    return SimpleNamespace(
        name=name, id=id_, is_user_annotation=annotation,
        device_type=DeviceType.CUDA if device == "cuda" else DeviceType.CPU,
        time_range=SimpleNamespace(start=start, end=end,
                                   elapsed_us=lambda s=start, e=end: e - s))


def test_kernel_scopes_places_launches_among_the_ranges():
    events = [
        _event("DynCore", 0, 100, annotation=True),
        _event("HaloExchange", 10, 20, annotation=True),
        _event("TracerAdvection", 120, 200, annotation=True),
        _event("cudaLaunchKernel", 12, 13, id_=1),
        _event("cudaLaunchKernel", 50, 51, id_=2),
        _event("cudaLaunchKernel", 150, 151, id_=3),
        _event("cudaMemcpyAsync", 110, 111, id_=4),
        _event("halo_gather", 13, 40, "cuda", id_=1),
        _event("d_sw_tail", 51, 60, "cuda", id_=2),
        _event("fvtp2d", 151, 170, "cuda", id_=3),
        _event("Memcpy DtoH", 111, 112, "cuda", id_=4),
        _event("DynCore", 0, 100, "cuda", annotation=True),
    ]
    got = sorted(stage_profile.kernel_scopes(events))
    assert got == sorted([(27, ("DynCore", "HaloExchange")), (9, ("DynCore",)),
                          (19, ("TracerAdvection",)), (1, ())])


def test_profile_stage_times_is_empty_on_the_cpu():
    def f(x):
        with stage_range("DynCore"):
            return (x * 2.0).sum()

    assert stage_profile.profile_stage_times(f, torch.ones(8, 8)) == {}


def test_stage_range_records_only_under_a_profiler():
    import contextlib

    assert isinstance(stage_range("DynCore"), contextlib.nullcontext)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with stage_range("DynCore"):
            torch.ones(3).sum()
    assert "DynCore" in {e.name for e in prof.events() if e.is_user_annotation}


def _ranges_of(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events() if e.is_user_annotation}


@pytest.mark.parametrize("hydrostatic", [True, False], ids=["hydrostatic", "nonhydrostatic"])
def test_the_step_carries_every_stage_range(hydrostatic, monkeypatch):
    """The ranges pace_tpu's named scopes mark, at the same places, inside the
    port's ``FVDynamics`` range over the whole step; the host syncs of the
    step (the sub-cycle count, the scalars copied to the device) carry
    ranges of their own. ``scalar_like`` copies a value only the first time
    a process asks for it, so the step runs with an empty cache."""
    from pace_tpu_torch.ops import stencil_utils

    monkeypatch.setattr(stencil_utils, "_SCALARS", {})
    mt = MetricTerms.generate(GridSpec(n_tile=12, npz=4, layout=(1, 1)))
    grid = GridData.from_metric_terms(mt, device="cpu", dtype=torch.float64)
    st = DycoreState.from_baroclinic_init(mt, device="cpu", dtype=torch.float64)
    core = DynamicalCore(grid, mt.halo, DynamicalCoreConfig(
        npz=4, hydrostatic=hydrostatic, n_split=1, beta=0.0), 300.0)
    names = _ranges_of(lambda: core.step_dynamics(st))
    want = {"FVDynamics", "DynCore", "TracerAdvection", "Remapping", "HaloExchange", "C_SW",
            "D_SW", "PGradD"}
    if not hydrostatic:
        want |= {"UpdateDZ", "RiemannC", "Riemann3"}
    assert {n for n in names if not n.startswith("HostSync.")} == want
    assert {n for n in names if n.startswith("HostSync.")} == {
        "HostSync.tracer_subcycles", "HostSync.scalar_like"}


def test_a_physics_call_carries_its_stage_ranges():
    from pace_tpu_torch.demos import physics_step as pdemo

    case = pdemo.build_case(12, 4, device="cpu", dtype=torch.float64, k_split=1, n_split=1,
                            **pdemo.EARTHLIKE)
    names = _ranges_of(lambda: case.physics(case.state, 0.0))
    assert {"Radiation", "Surface", "PBL", "DeepConvection", "ShallowConvection",
            "Microphysics"} <= names


# ---------------------------------------------------------------------------
# safety checks, and the surface restart's names
# ---------------------------------------------------------------------------
def test_safety_checker_raises_as_pace_tpu_s():
    pt = np.full((1, 2, 8, 8), 500.0, dtype=np.float32)
    pt[0, 1, 3, 4] = 0.1
    delp = np.full((1, 2, 8, 8), 10.0)
    delp[0, 0, 4, 4] = np.nan
    msgs = []
    for checker_cls, wrap in ((SafetyChecker, torch.from_numpy), (jsafety.SafetyChecker,
                                                                 jnp.asarray)):
        checker = checker_cls()
        checker.register_variable("pt", 100.0, 380.0)
        checker.register_variable("delp", 0.0, 100.0)
        checker.register_variable("absent")
        with pytest.raises(RuntimeError) as err:
            checker.check_state(SimpleNamespace(pt=wrap(pt), delp=wrap(delp), absent=None),
                                n_halo=2)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert "pt: min 0.1" in msgs[0] and "pt: max 500.0 > 380.0" in msgs[0]
    assert "delp: NaN detected" in msgs[0]


def test_safety_checker_passes_and_ignores_ghosts():
    pt = torch.full((1, 2, 8, 8), 300.0)
    pt[..., 0, :] = float("nan")  # a ghost row
    checker = SafetyChecker()
    checker.register_variable("pt", 100.0, 380.0)
    checker.check_state(SimpleNamespace(pt=pt), n_halo=2)
    checker.register_variable("pt", 100.0, 380.0, compute_domain_only=False)
    with pytest.raises(RuntimeError, match="NaN"):
        checker.check_state(SimpleNamespace(pt=pt), n_halo=2)


@pytest.mark.parametrize("kind", ["land", "seaice", "mixed"])
def test_surface_leaf_names_are_jax_keystr_names(kind):
    jmt = JMetricTerms.generate(JGridSpec(n_tile=12, npz=4, layout=(1, 1)))
    mt = MetricTerms.generate(GridSpec(n_tile=12, npz=4, layout=(1, 1)))
    jgrid = SimpleNamespace(f0=jnp.asarray(jmt.f0))
    tgrid = SimpleNamespace(f0=torch.from_numpy(mt.f0))
    jsfc = jsurface.build_surface(jsurface.SurfaceConfig(type=kind), grid=jgrid).init(
        (6, 18, 18), jnp.float64)
    tsfc = tsurface.build_surface(tsurface.SurfaceConfig(type=kind), grid=lambda: tgrid).init(
        (6, 18, 18), torch.float64, device="cpu")
    want = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_leaves_with_path(jsfc)]
    assert [n for n, _ in surface_leaves(tsfc)] == want
