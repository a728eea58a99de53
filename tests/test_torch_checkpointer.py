"""The port's stage checkpointers against pace_tpu's, and the port validated
against pace_tpu's committed golden savepoints, on the CPU in float64.

- The thresholds YAML: the port's reader (its YAML subset) gives what
  PyYAML gives for both committed files; what the port writes, PyYAML reads
  back, and the port reads what ``pace_tpu`` writes.
- Snapshot files cross both ways: ``pace_tpu`` loads what the port's
  ``savepoint_cli generate`` records, and the port loads the committed
  recordings as ``pace_tpu`` does.
- The stages a step fires: ``savepoint_cli generate --device cpu`` on the
  two golden configs records the stages of the committed recordings
  (``tests/data/savepoints/ref_c12*.npz``, recorded by ``pace_tpu``), in
  their order, each hit with the same variables. ``Physics`` fires
  ``Physics-In`` and ``Physics-Out`` with ``pace_tpu``'s variables at both
  of its returns (with and without the microphysics), their values within
  1e-12 of each field's scale.
- The golden savepoints validate, with no JAX run: the port's recordings of
  the hydrostatic config (1 step) and the nonhydrostatic one (3 steps) are
  within the committed thresholds at every checkpoint on whole arrays, ghost
  cells included, and ``savepoint_cli validate --device cpu``, which
  compares the compute domain (``n_halo``), exits 0 on the first.
- Calibration: ``perturb`` draws what ``pace_tpu``'s draws; two calibrated
  trials give thresholds under which a third perturbed run validates and a
  corrupted one does not.
- ``PairStageComparator``: an identical replica passes, a one-ulp change
  is caught at the first stage that sees it, naming the stage, the variable
  and the hit.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pace_tpu.models.shield import physics as jphys
from pace_tpu.testing import checkpointer as jck
from pace_tpu.testing.perturb import perturb as jperturb
from pace_tpu_torch.grid.generation import GridSpec, MetricTerms
from pace_tpu_torch.grid.grid_data import GridData
from pace_tpu_torch.models.fv3.dycore import DynamicalCore, DynamicalCoreConfig
from pace_tpu_torch.models.fv3.state import DycoreState
from pace_tpu_torch.models.shield import physics as tphys
from pace_tpu_torch.testing import (
    PairStageComparator, SavepointThresholds, SnapshotCheckpointer, Threshold,
    ThresholdCalibrationCheckpointer, ValidationCheckpointer, ValidationError, perturb,
)
from pace_tpu_torch.testing.savepoint_cli import main as cli

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "savepoints")
GOLDEN = {
    "hydrostatic": ("baroclinic_c12.yaml", "ref_c12.npz", "thresholds_c12.yaml", 1),
    "nonhydrostatic": ("baroclinic_c12_nh.yaml", "ref_c12_nh.npz", "thresholds_c12_nh.yaml", 3),
}
H = 3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the C12 arrays gain nothing from more, and the
    other workers of a parallel test run hold the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def golden(case):
    cfg, ref, th, steps = GOLDEN[case]
    return os.path.join(DATA, cfg), os.path.join(DATA, ref), os.path.join(DATA, th), steps


@pytest.mark.parametrize("case", sorted(GOLDEN))
def test_thresholds_yaml_matches_pyyaml(case, tmp_path):
    _, _, th, _ = golden(case)
    with open(th) as f:
        raw = yaml.safe_load(f)
    got = SavepointThresholds.from_yaml(th)
    assert {s: {v: dataclasses.asdict(t) for v, t in vs.items()}
            for s, vs in got.savepoints.items()} == raw
    out = str(tmp_path / "port.yaml")
    got.to_yaml(out)
    with open(out) as f:
        assert yaml.safe_load(f) == raw
    jout = str(tmp_path / "jax.yaml")
    jck.SavepointThresholds.from_yaml(th).to_yaml(jout)
    assert SavepointThresholds.from_yaml(jout).savepoints == got.savepoints


@pytest.fixture(scope="module", params=sorted(GOLDEN))
def recorded(request, tmp_path_factory):
    """The port's recording of a golden config (``savepoint_cli generate``)."""
    cfg, ref, th, steps = golden(request.param)
    out = str(tmp_path_factory.mktemp("rec") / "port.npz")
    assert cli(["generate", cfg, "-o", out, "--steps", str(steps), "--device", "cpu"]) == 0
    return dict(case=request.param, out=out, ref=ref)


def test_stages_order_and_variables_are_pace_tpu_s(recorded):
    port = np.load(recorded["out"], allow_pickle=True)
    gold = np.load(recorded["ref"], allow_pickle=True)
    assert [tuple(r) for r in port["__counts__"]] == [tuple(r) for r in gold["__counts__"]]
    # every hit holds the same variables, recorded in the same order
    assert port.files == gold.files
    for key in gold.files[1:]:
        assert port[key].shape == gold[key].shape and port[key].dtype == gold[key].dtype, key


def test_recordings_cross_both_ways(recorded):
    port = SnapshotCheckpointer.load(recorded["out"])
    jport = jck.SnapshotCheckpointer.load(recorded["out"])
    gold = SnapshotCheckpointer.load(recorded["ref"])
    jgold = jck.SnapshotCheckpointer.load(recorded["ref"])
    for mine, theirs in ((port, jport), (gold, jgold)):
        assert list(mine.data) == list(theirs.data)
        for stage, hits in theirs.data.items():
            assert len(mine.data[stage]) == len(hits)
            for a, b in zip(mine.data[stage], hits):
                assert list(a) == list(b)
                assert all(np.array_equal(a[k], b[k]) for k in b), stage


def replay(recording, reference, thresholds):
    """Validate a recording of a run against ``reference`` as the run's
    ValidationCheckpointer would have (it counts the hits of each stage
    apart, so the order across stages does not matter)."""
    chk = ValidationCheckpointer(reference, thresholds)
    with chk.trial():
        for stage, hits in recording.data.items():
            for hit in hits:
                chk(stage, **hit)
    return sum(chk._hit.values())


def test_golden_savepoints_validate(recorded):
    """The port's run of each golden config within the committed thresholds
    of pace_tpu's recording, at every checkpoint."""
    _, ref, th, _ = golden(recorded["case"])
    port = SnapshotCheckpointer.load(recorded["out"])
    n = replay(port, SnapshotCheckpointer.load(ref), SavepointThresholds.from_yaml(th))
    assert n == sum(len(h) for h in port.data.values()) > 0
    # a change of 1e-9 at one checkpoint is outside them
    bad = SnapshotCheckpointer.load(ref)
    hit = bad.data["D_SW-Out"][1]
    hit["pt"] = hit["pt"] * (1.0 + 1e-9)
    with pytest.raises(ValidationError, match=r"D_SW-Out\[1\]\.pt"):
        replay(port, bad, SavepointThresholds.from_yaml(th))


def test_savepoint_cli_validate_exits_0(capsys):
    cfg, ref, th, steps = golden("hydrostatic")
    assert cli(["validate", cfg, "-r", ref, "-t", th, "--steps", str(steps),
                "--device", "cpu"]) == 0
    assert ("validation passed: 12 checkpoints within thresholds on the compute domain\n"
            in capsys.readouterr().out)


def test_validation_on_the_compute_domain():
    """n_halo (what savepoint_cli validate takes) compares each array
    without its ghost rings, interface rows included, and no less."""
    _, ref, th, _ = golden("hydrostatic")
    reference = SnapshotCheckpointer.load(ref)
    thresholds = SavepointThresholds.from_yaml(th)
    hit = reference.data["D_SW-Out"][0]
    ghosts = {k: v.copy() for k, v in hit.items()}
    for v in ghosts.values():
        v[..., :3, :] = -1e9
        v[..., -3:, :] = -1e9
    for n_halo, ok in ((0, False), (3, True)):
        chk = ValidationCheckpointer(reference, thresholds, n_halo=n_halo)
        chk._hit = {"D_SW-Out": 0}
        chk("D_SW-Out", **ghosts)
        assert (chk.errors == []) == ok, n_halo
    # u's last compute row is its extra interface row: it is compared
    inner = {k: v.copy() for k, v in hit.items()}
    inner["u"][0, 0, -4, 5] += 1.0
    chk = ValidationCheckpointer(reference, thresholds, n_halo=3)
    chk("D_SW-Out", **inner)
    assert len(chk.errors) == 1 and chk.errors[0].startswith("D_SW-Out[0].u")


@pytest.fixture(scope="module")
def small():
    mt = MetricTerms.generate(GridSpec(n_tile=12, npz=4, layout=(1, 1)))
    grid = GridData.from_metric_terms(mt, device="cpu", dtype=torch.float64)
    cfg = DynamicalCoreConfig(npz=4, k_split=1, n_split=1, hydrostatic=True)
    state = DycoreState.from_analytic_init(mt, device="cpu", dtype=torch.float64)
    return mt, grid, cfg, state


def test_perturb_is_pace_tpu_s(small):
    from pace_tpu.models.fv3.state import DycoreState as JDycoreState

    *_, state = small
    jstate = JDycoreState(**{f.name: None if getattr(state, f.name) is None
                             else jnp.asarray(getattr(state, f.name).numpy())
                             for f in dataclasses.fields(state)})
    got, want = perturb(state, 1e-13, seed=3), jperturb(jstate, 1e-13, seed=3)
    for f in dataclasses.fields(state):
        g = getattr(got, f.name)
        if g is None:
            assert getattr(want, f.name) is None
            continue
        assert np.array_equal(g.numpy(), np.asarray(getattr(want, f.name))), f.name
        assert not torch.equal(g, getattr(state, f.name)) or not g.any(), f.name


def test_calibrate_then_validate(small):
    mt, grid, cfg, state = small
    snap = SnapshotCheckpointer()
    DynamicalCore(grid, mt.halo, cfg, 60.0, checkpointer=snap).step_dynamics(state)
    calib = ThresholdCalibrationCheckpointer(snap, factor=10.0)
    core = DynamicalCore(grid, mt.halo, cfg, 60.0, checkpointer=calib)
    for trial in range(2):
        with calib.trial():
            core.step_dynamics(perturb(state, 1e-13, seed=trial + 1))
    th = calib.thresholds()
    assert list(th.savepoints) == list(snap.data)
    assert th.savepoints["FVDynamics-Out"]["u"].absolute > 0.0
    val = ValidationCheckpointer(snap, th)
    core_v = DynamicalCore(grid, mt.halo, cfg, 60.0, checkpointer=val)
    with val.trial():
        core_v.step_dynamics(perturb(state, 1e-13, seed=99))
    with pytest.raises(ValidationError, match="FVDynamics-In"):
        with val.trial():
            core_v.step_dynamics(dataclasses.replace(state, u=state.u * 1.001))


def test_threshold_check_semantics():
    for cls in (Threshold, jck.Threshold):
        t = cls(absolute=1e-3, relative=0.0)
        a = np.array([1.0, 2.0])
        assert t.check("x", a, a + 5e-4) is None
        assert "x" in t.check("x", a, a + 5e-3)
        t2 = cls(absolute=0.0, relative=1e-2)
        assert t2.check("y", np.array([100.0]), np.array([100.5])) is None
        assert t2.check("y", np.array([100.0]), np.array([105.0])) is not None
    a, b = np.array([1.0, np.nan, 3.0]), np.array([1.5, np.nan, 3.0])
    assert Threshold(0.1, 0.0).check("z", a, b) == jck.Threshold(0.1, 0.0).check("z", a, b)


class _Bump:
    """Hands the comparator one variable one ulp up at one stage hit."""

    def __init__(self, inner, stage, name, hit):
        self.inner, self.stage, self.name, self.hit = inner, stage, name, hit
        self.seen = 0

    def __call__(self, stage, **variables):
        if stage == self.stage:
            if self.seen == self.hit:
                v = variables[self.name].clone()
                v[0, 0, 8, 8] = torch.nextafter(v[0, 0, 8, 8], torch.tensor(np.inf,
                                                                            dtype=v.dtype))
                variables[self.name] = v
            self.seen += 1
        self.inner(stage, **variables)


def test_pair_comparator_names_the_stage(small):
    mt, grid, cfg, state = small
    cfg = dataclasses.replace(cfg, n_split=2)
    snap = SnapshotCheckpointer()
    cmp_ = PairStageComparator(snap)
    primary = DynamicalCore(grid, mt.halo, cfg, 60.0, checkpointer=snap)
    cmp_.begin_step()
    primary.step_dynamics(state)
    DynamicalCore(grid, mt.halo, cfg, 60.0, checkpointer=cmp_).step_dynamics(state)
    # a one-ulp change in the replica's input: caught at the first stage
    pt = state.pt.clone()
    pt[0, 2, 9, 9] = torch.nextafter(pt[0, 2, 9, 9], torch.tensor(np.inf, dtype=pt.dtype))
    cmp_.begin_step()
    primary.step_dynamics(state)
    with pytest.raises(RuntimeError, match=r"FVDynamics-In.*'pt'.*hit 0"):
        DynamicalCore(grid, mt.halo, cfg, 60.0, checkpointer=cmp_).step_dynamics(
            dataclasses.replace(state, pt=pt))
    # one ulp of u at the second substep's D-grid output
    cmp_.begin_step()
    primary.step_dynamics(state)
    with pytest.raises(RuntimeError, match=r"D_SW-Out.*'u'.*hit 1: max\|diff\|"):
        DynamicalCore(grid, mt.halo, cfg, 60.0,
                      checkpointer=_Bump(cmp_, "D_SW-Out", "u", 1)).step_dynamics(state)


@pytest.fixture(scope="module")
def moist():
    from pace_tpu.grid.generation import GridSpec as JGridSpec
    from pace_tpu.grid.generation import MetricTerms as JMetricTerms
    from pace_tpu.grid.grid_data import GridData as JGridData
    from pace_tpu.models.fv3.state import DycoreState as JDycoreState
    from pace_tpu_torch.demos import physics_step as pdemo

    jm = JMetricTerms.generate(JGridSpec(n_tile=12, npz=8, layout=(1, 1)))
    tm = MetricTerms.generate(GridSpec(n_tile=12, npz=8, layout=(1, 1)))
    tstate = DycoreState.from_analytic_init(tm, device="cpu", dtype=torch.float64)
    tstate.q = torch.from_numpy(pdemo.moist_tracers(tstate, seed=0).copy())
    jstate = JDycoreState(**{f.name: None if getattr(tstate, f.name) is None
                             else jnp.asarray(getattr(tstate, f.name).numpy())
                             for f in dataclasses.fields(tstate)})
    return dict(jgrid=JGridData.from_metric_terms(jm, dtype=jnp.float64),
                tgrid=GridData.from_metric_terms(tm, device="cpu", dtype=torch.float64),
                jstate=jstate, tstate=tstate)


@pytest.mark.parametrize("schemes", [("GFS_microphysics",), ("held_suarez",)],
                         ids=["microphysics", "held_suarez"])
def test_physics_stages_are_pace_tpu_s(moist, schemes):
    jsnap, tsnap = jck.SnapshotCheckpointer(), SnapshotCheckpointer()
    jphys.Physics(moist["jgrid"], schemes, 225.0, checkpointer=jsnap)(moist["jstate"])
    tphys.Physics(moist["tgrid"], schemes, 225.0, checkpointer=tsnap)(moist["tstate"])
    assert list(tsnap.data) == list(jsnap.data) == ["Physics-In", "Physics-Out"]
    for stage, hits in jsnap.data.items():
        assert len(tsnap.data[stage]) == len(hits) == 1
        got, want = tsnap.data[stage][0], hits[0]
        assert list(got) == list(want) == ["u", "v", "pt", "delp", "q"]
        for k in want:
            w, g = want[k][..., H:-H, H:-H], got[k][..., H:-H, H:-H]
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-12 * np.abs(w).max(),
                                       err_msg=f"{stage}.{k}")
