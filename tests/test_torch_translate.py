"""The translate framework: ``tests/main/test_translate.py`` against the
port, and the savepoint initialization against pace_tpu's.

The savepoint dict is made by the framework itself from a C12, npz=5
baroclinic state and round-tripped: the names, the re-embedding with and
without halo cells, NetCDF-3 and HDF5 files (``h5py`` is installed here;
without it an HDF5 savepoint raises an ``ImportError`` naming it), the
relative-error comparison with its near-zero ignores. Then an
``FVDynamics-In`` NetCDF file written by the port's ``TranslateFVDynamics``
initializes the state through ``initialization.type: savepoint`` in both
packages, equal bit for bit in float64, and through the driver config
``baroclinic_c12_from_savepoint.yaml`` (cut to npz=5, one step on the CPU).
"""

import builtins
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.driver.initialization import InitializationConfig as JInitializationConfig
from pace_tpu.grid.generation import GridSpec as JGridSpec
from pace_tpu.grid.generation import MetricTerms as JMetricTerms
from pace_tpu.testing import translate as jtranslate
from pace_tpu_torch.driver.config import DriverConfig
from pace_tpu_torch.driver.driver import Driver
from pace_tpu_torch.driver.initialization import InitializationConfig
from pace_tpu_torch.grid.generation import GridSpec, MetricTerms
from pace_tpu_torch.models.fv3.state import DycoreState
from pace_tpu_torch.testing.translate import (
    FORTRAN_NAME_MAP,
    TRACER_FORTRAN_NAMES,
    TranslateFVDynamics,
    dataset_to_dict,
)
from pace_tpu_torch.utils import netcdf3, yaml_subset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the C12 arrays gain nothing from more, and the
    other workers of a parallel test run hold the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mt():
    return MetricTerms.generate(GridSpec(n_tile=12, npz=5, layout=(1, 1)))


@pytest.fixture(scope="module")
def state(mt):
    return DycoreState.from_analytic_init(mt, perturbation=True, device="cpu",
                                          dtype=torch.float32)


def test_names_are_pace_tpu_s():
    assert FORTRAN_NAME_MAP == jtranslate.FORTRAN_NAME_MAP
    assert TRACER_FORTRAN_NAMES == jtranslate.TRACER_FORTRAN_NAMES


def test_roundtrip_state_outputs_inputs(mt, state):
    tr = TranslateFVDynamics(mt, device="cpu", dtype=torch.float32)
    outs = tr.outputs_from_state(state)
    for name in FORTRAN_NAME_MAP:
        assert name in outs or getattr(state, FORTRAN_NAME_MAP[name]) is None
    for name in TRACER_FORTRAN_NAMES:
        assert name in outs
    st2 = tr.state_from_inputs(outs)
    h = mt.halo.n_halo
    ny, nx = mt.halo.nsy, mt.halo.nsx
    assert torch.equal(st2.delp[..., h:h + ny, h:h + nx], state.delp[..., h:h + ny, h:h + nx])
    # the staggered field keeps its extra row
    assert torch.equal(st2.u[..., h:h + ny + 1, h:h + nx], state.u[..., h:h + ny + 1, h:h + nx])
    assert torch.equal(st2.q[:, 0, :, h:h + ny, h:h + nx],
                       state.q[:, 0, :, h:h + ny, h:h + nx])
    # the halo of the rebuilt state is zero (the savepoints carry no halo)
    assert float(st2.delp[..., :h, :].abs().max()) == 0.0


def test_dataset_to_dict_netcdf3(tmp_path, mt, state):
    outs = TranslateFVDynamics(mt, device="cpu").outputs_from_state(state)
    path = os.path.join(tmp_path, "savepoint.nc")
    netcdf3.write_simple(path, outs)
    back = dataset_to_dict(path)
    assert set(back) == set(outs)
    assert np.array_equal(back["pt"], outs["pt"])
    assert all(np.array_equal(back[k], v) for k, v in jtranslate.dataset_to_dict(path).items())


def test_dataset_to_dict_hdf5(tmp_path, mt, state, monkeypatch):
    import h5py

    outs = TranslateFVDynamics(mt, device="cpu").outputs_from_state(state)
    path = os.path.join(tmp_path, "savepoint.h5")
    with h5py.File(path, "w") as f:
        for k, v in outs.items():
            f.create_dataset(k, data=v)
    back = dataset_to_dict(path)
    assert set(back) == set(outs)
    assert np.array_equal(back["u"], outs["u"])
    # without h5py an HDF5 savepoint is refused by name
    real_import = builtins.__import__

    def no_h5py(name, *a, **k):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ImportError, match="h5py"):
        dataset_to_dict(path)


def test_compare_thresholds(mt, state):
    tr = TranslateFVDynamics(mt, device="cpu")
    outs = tr.outputs_from_state(state)
    ref = {k: np.asarray(v) for k, v in outs.items()}
    assert tr.compare(outs, ref) == []
    perturbed = dict(outs)
    perturbed["pt"] = ref["pt"] * (1.0 + 1e-3)
    fails = tr.compare(perturbed, ref)
    assert len(fails) == 1 and fails[0].startswith("pt")
    assert fails == jtranslate.TranslateFVDynamics(None).compare(perturbed, ref)
    tiny = {"z": np.full(4, 1e-12)}
    got = {"z": np.full(4, 3e-12)}
    assert tr.compare(got, tiny) != []
    assert tr.compare(got, tiny, ignore_near_zero={"z": 1e-8}) == []


def test_data_halo_embedding(mt, state):
    """Slabs serialized WITH halo cells land at the right offset."""
    h = mt.halo.n_halo
    ny, nx = mt.halo.nsy, mt.halo.nsx
    dh = 1
    tr1 = TranslateFVDynamics(mt, data_halo=dh, device="cpu")
    slab = state.delp[..., h - dh:h + ny + dh, h - dh:h + nx + dh].numpy()
    st = tr1.state_from_inputs({"delp": slab})
    assert torch.equal(st.delp[..., h:h + ny, h:h + nx], state.delp[..., h:h + ny, h:h + nx])


@pytest.fixture(scope="module")
def savepoint_file(mt, tmp_path_factory):
    """An FVDynamics-In file with 3 halo cells, of a float64 state with
    seeded tracers."""
    st = DycoreState.from_analytic_init(mt, device="cpu", dtype=torch.float64)
    st.q = torch.from_numpy(np.random.RandomState(5).uniform(0, 1e-3, st.q.shape))
    # the padded arrays: the compute domain with its 3 halo cells a side;
    # not cxd and cyd, whose staggering the framework does not know (as
    # pace_tpu's does not: ROADMAP queue 3)
    arrays = {}
    for fname, sname in FORTRAN_NAME_MAP.items():
        a = getattr(st, sname)
        if a is not None and fname not in ("cxd", "cyd"):
            arrays[fname] = a.numpy()
    for i, t in enumerate(TRACER_FORTRAN_NAMES):
        arrays[t] = st.q[:, i].numpy()
    path = str(tmp_path_factory.mktemp("savepoints") / "FVDynamics-In.nc")
    netcdf3.write_simple(path, arrays)
    return dict(path=path, state=st)


def test_savepoint_initialization_matches(mt, savepoint_file):
    cfg = {"path": savepoint_file["path"], "data_halo": 3}
    got = InitializationConfig(type="savepoint", config=cfg).get_dycore_state(
        mt, "cpu", torch.float64)
    jmt = JMetricTerms.generate(JGridSpec(n_tile=12, npz=5, layout=(1, 1)))
    want = JInitializationConfig(type="savepoint", config=cfg).get_dycore_state(
        jmt, jnp.float64)
    for name in ("u", "v", "w", "delz", "delp", "pt", "q", "ps", "pe", "peln", "pk", "pkz",
                 "phis", "ua", "va", "uc", "vc"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == torch.float64, name
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    # the compute domain is the source state's
    src = savepoint_file["state"]
    for name in ("u", "delp", "pt", "q"):
        a, b = getattr(got, name), getattr(src, name)
        assert torch.equal(a[..., 3:a.shape[-2] - 3, 3:a.shape[-1] - 3],
                           b[..., 3:b.shape[-2] - 3, 3:b.shape[-1] - 3]), name


def test_from_savepoint_config_runs(savepoint_file, tmp_path):
    with open(os.path.join(ROOT, "examples", "configs", "baroclinic_c12_from_savepoint.yaml")) as f:
        raw = yaml_subset.safe_load(f)
    raw.update(nz=5, minutes=0, seconds=225, precision=64)
    raw["initialization"]["config"]["path"] = savepoint_file["path"]
    raw["diagnostics_config"].update(path=str(tmp_path / "output"))
    d = Driver(DriverConfig.from_dict(raw), device="cpu")
    src = savepoint_file["state"]
    assert torch.equal(d.state.delp[..., 3:-3, 3:-3], src.delp[..., 3:-3, 3:-3])
    d.step_all()
    d.cleanup()
    assert d._step_count == 1
    assert bool(torch.isfinite(d.state.u[..., 3:-3, 3:-3]).all())
