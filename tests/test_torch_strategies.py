"""The port's halo strategies against pace_tpu's, and the three comm configs.

- Every method of ``ConstantFillHalo``, ``RecordingHalo``, ``ReplayHalo``
  and ``NanCheckingHalo``, the compound ones of ``_FoldsDefaultsMixin``
  included, on seeded C12 float64 fields, equal to ``pace_tpu``'s, with the
  same recorded tags.
- ``examples/configs/baroclinic_c12_comm_write.yaml`` at nz=4, float64, one
  step, recorded by each package and replayed by the other: ``pace_tpu``
  records under ``jax.disable_jit()`` in a subprocess started with the
  module (its op-by-op compiles take half a minute, and the other tests run
  meanwhile), with the tracer transport on its batched branch, the branch
  ``pace_tpu`` takes on the chip (its fused tracer kernel in interpret
  mode), whose exchanges the port's make, and with the remap and the
  exchanges themselves (copies: the same bits) jitted. The two recordings hold the same tags; each replay
  ends within 1e-12 of each field's scale of the recording run, and the
  port's own write and read runs are bit-identical.
- The null-comm driver run of ``tests/main/test_comm_strategies.py``.
"""

import copy
import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.grid.generation import GridSpec as JGridSpec
from pace_tpu.grid.generation import MetricTerms as JMetricTerms
from pace_tpu.parallel import strategies as jst
from pace_tpu_torch.driver.config import DriverConfig
from pace_tpu_torch.driver.driver import Driver
from pace_tpu_torch.grid.generation import GridSpec, MetricTerms
from pace_tpu_torch.parallel import strategies as tst
from pace_tpu_torch.utils import yaml_subset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(ROOT, "examples", "configs")
H = 3
#: the state of the hydrostatic comm configs (no w, no delz)
FIELDS = ("u", "v", "delp", "pt", "q", "ps", "pe", "peln", "pk", "pkz", "ua", "va", "uc", "vc",
          "mfxd", "mfyd", "cxd", "cyd")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def halos():
    jhalo = JMetricTerms.generate(JGridSpec(n_tile=12, npz=3, layout=(1, 1))).halo
    thalo = MetricTerms.generate(GridSpec(n_tile=12, npz=3, layout=(1, 1))).halo
    return jhalo, thalo


def _fields(halo, seed):
    rng = np.random.default_rng(seed)
    S, ny, nx = halo.n_shards, halo.nsy + 2 * H, halo.nsx + 2 * H
    return {"q": rng.standard_normal((S, 3, ny, nx)),
            "q2": rng.standard_normal((S, 3, ny, nx)),
            "u": rng.standard_normal((S, 3, ny + 1, nx)),
            "v": rng.standard_normal((S, 3, ny, nx + 1)),
            "qc": rng.standard_normal((S, 3, ny + 1, nx + 1))}


def _calls(f):
    """Every public method of a strategy, as (name, call) pairs taking the
    package's array constructor."""
    return [
        ("update_scalar", lambda h, a: h.update_scalar(a(f["q"]), fold="y")),
        ("update_scalar corner", lambda h, a: h.update_scalar(a(f["qc"]), stagger="corner")),
        ("update_scalars", lambda h, a: h.update_scalars([a(f["q"]), a(f["q2"])], fold="x")),
        ("update_vector", lambda h, a: h.update_vector(a(f["u"]), a(f["v"]), fold="y")),
        ("update_vector cgrid", lambda h, a: h.update_vector(a(f["v"]), a(f["u"]),
                                                             kind="cgrid", fold="x")),
        ("sync_vector_interfaces", lambda h, a: h.sync_vector_interfaces(a(f["u"]), a(f["v"]))),
        ("update_scalar_folds", lambda h, a: h.update_scalar_folds(a(f["q"]))),
        ("update_scalars_folds", lambda h, a: h.update_scalars_folds([a(f["q"]), a(f["q2"])])),
        ("update_vector_folds", lambda h, a: h.update_vector_folds(a(f["u"]), a(f["v"]))),
        ("start_update_scalars_folds",
         lambda h, a: h.start_update_scalars_folds([a(f["q"]), a(f["q2"])]).wait()),
        ("update_scalar_fold_patch", lambda h, a: h.update_scalar_fold_patch(a(f["q"]))),
        ("update_scalars_fold_patches",
         lambda h, a: h.update_scalars_fold_patches([a(f["q"]), a(f["q2"])])),
        ("start_update_scalars_fold_patches",
         lambda h, a: h.start_update_scalars_fold_patches([a(f["q2"]), a(f["q"])]).wait()),
        ("update_vector_fold_pair", lambda h, a: h.update_vector_fold_pair(a(f["u"]), a(f["v"]))),
        ("update_vector_fold_pair agrid",
         lambda h, a: h.update_vector_fold_pair(a(f["q"]), a(f["q2"]), kind="agrid",
                                                fold_u="x", fold_v="y")),
        ("_patch_of", lambda h, a: h._patch_of(a(f["q"]))),
    ]


def _leaves(x):
    if isinstance(x, (list, tuple)):
        return [leaf for item in x for leaf in _leaves(item)]
    return [np.asarray(x)]


def _assert_same(got, want, label):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w), label
    for a, b in zip(g, w):
        assert a.shape == b.shape, label
        np.testing.assert_array_equal(a, b, err_msg=label)


def _torch(a):
    return torch.from_numpy(np.array(a))


def _jax(a):
    return jnp.asarray(a)


@pytest.mark.parametrize("kind", ["constant_fill", "recording", "nan_checking"])
def test_strategy_methods_match_pace_tpu(halos, kind):
    jhalo, thalo = halos
    make = {"constant_fill": lambda m, h: m.ConstantFillHalo(h, fill_value=7.5),
            "recording": lambda m, h: m.RecordingHalo(h),
            "nan_checking": lambda m, h: m.NanCheckingHalo(h, name="test")}[kind]
    js, ts = make(jst, jhalo), make(tst, thalo)
    for attr in ("n_halo", "n_tile", "n_shards", "nsy", "nsx"):
        assert getattr(ts, attr) == getattr(js, attr)
    for name, call in _calls(_fields(thalo, seed=11)):
        _assert_same(call(ts, _torch), call(js, _jax), f"{kind} {name}")
    if kind == "recording":
        assert ts._ops == js._ops
        _assert_same(ts.records, js.records, "records")
    if kind == "nan_checking":
        assert ts.calls == js.calls


def test_replay_matches_pace_tpu_and_crosses_in_both_directions(halos, tmp_path):
    """Each package's recording of every method, replayed by both packages:
    the same results, in order; a call off the recorded sequence raises, as
    does one past its end."""
    jhalo, thalo = halos
    f = _fields(thalo, seed=12)
    jrec, trec = jst.RecordingHalo(jhalo), tst.RecordingHalo(thalo)
    want = [call(jrec, _jax) for _n, call in _calls(f)]
    for _n, call in _calls(f):
        call(trec, _torch)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jrec.save(jpath)
    trec.save(tpath)
    for path in (jpath, tpath):
        for pkg, halo, arr in ((jst, jhalo, _jax), (tst, thalo, _torch)):
            rep = pkg.ReplayHalo(path, halo)
            for (name, call), w in zip(_calls(f), want):
                _assert_same(call(rep, arr), w, f"{pkg.__name__} replay of {path}: {name}")
            with pytest.raises(RuntimeError, match="exhausted"):
                rep.update_scalar(arr(f["q"]))
    rep = tst.ReplayHalo(trec)
    assert rep.n_shards == 6
    with pytest.raises(RuntimeError, match="replay divergence at call 0"):
        rep.update_vector(_torch(f["u"]), _torch(f["v"]))


def test_constant_fill_and_nan_checker_behave_as_pace_tpu_tests_them(halos):
    """tests/main/test_comm_strategies.py's two checks on the port."""
    _jhalo, thalo = halos
    fill = tst.ConstantFillHalo(thalo, fill_value=7.0)
    out = fill.update_scalar(torch.ones((6, 4, 18, 18), dtype=torch.float64))
    assert bool((out[:, :, H:-H, H:-H] == 1.0).all())
    assert bool((out[:, :, :H, :] == 7.0).all()) and bool((out[:, :, :, -H:] == 7.0).all())
    u, v = torch.ones((6, 4, 19, 18)), torch.ones((6, 4, 18, 19))
    assert fill.sync_vector_interfaces(u, v) == (u, v)
    chk = tst.NanCheckingHalo(thalo)
    q = torch.zeros((6, 4, 18, 18), dtype=torch.float64)
    chk.update_scalar(q)
    bad = q.clone()
    bad[0, 0, H + 2, H + 2] = float("nan")
    with pytest.raises(FloatingPointError, match="NaN in interior entering halo exchange #2"):
        chk.update_scalar(bad)
    ghost = q.clone()
    ghost[0, 0, 0, 0] = float("nan")
    chk.update_scalar(ghost)


def test_driver_null_comm_runs(tmp_path, monkeypatch):
    """tests/main/test_comm_strategies.py::test_driver_null_comm_runs on the
    port: a whole run with constant-fill halos ends, with no exchange (its
    answer does not matter)."""
    from pace_tpu_torch.parallel import halo_slabs

    calls = []
    monkeypatch.setattr(halo_slabs, "_exchange", lambda *a: calls.append(a))
    cfg = DriverConfig.from_dict(dict(
        nx_tile=12, nz=4, layout=[1, 1], dt_atmos=60.0, minutes=2,
        comm_config={"type": "null", "fill_value": 0.0},
        dycore_config={"k_split": 1, "n_split": 1, "hydrostatic": True},
        diagnostics_config={"path": str(tmp_path / "out"), "output_frequency": 10},
        safety_checks=[],
    ))
    d = Driver(cfg, device="cpu")
    assert isinstance(d.halo, tst.ConstantFillHalo) and d.halo.fill == 0.0
    d.step_all()
    d.cleanup()
    assert d._step_count == 2 and not calls


# ---------------------------------------------------------------------------
# the comm configs across the packages
# ---------------------------------------------------------------------------

_PACE_TPU_RUNS = textwrap.dedent('''
    import json, os, sys, time
    import jax
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    from pace_tpu.ops import _dispatch
    from pace_tpu.driver.config import DriverConfig
    from pace_tpu.driver.driver import Driver

    plain = _dispatch.use_pallas

    def use_pallas(name):
        # the tracer transport's batched branch, as on the chip
        if name == "fvtp2d" and sys._getframe(1).f_code.co_name == "advect_tracers":
            return True
        return plain(name)

    _dispatch.use_pallas = use_pallas

    # the remap, which makes no exchange, and the exchanges themselves (copies
    # and sign flips: the same bits either way) compiled whole; op by op their
    # compiles would take most of the eager run. The strategy still sees every
    # exchange's result, eagerly, in order.
    from pace_tpu.models.fv3 import dycore
    from pace_tpu.parallel import halo

    compiled = {}

    def jitted(cls, name):
        eager = getattr(cls, name)

        def call(self, *args, **kw):
            static = {k: v for k, v in kw.items() if isinstance(v, str)}
            key = (name, id(self), tuple(sorted(static.items())))
            if key not in compiled:
                compiled[key] = jax.jit(lambda *a, **d: eager(self, *a, **static, **d))
            with jax.disable_jit(False):
                return compiled[key](*args, **{k: v for k, v in kw.items() if k not in static})

        setattr(cls, name, call)

    jitted(dycore.DynamicalCore, "_remap")
    for name in ("update_scalar", "update_vector", "sync_vector_interfaces"):
        jitted(halo.HaloExchanger, name)
    fields = json.loads(sys.argv[3])
    for raw, out in ((json.loads(sys.argv[1]), sys.argv[2] + "_write.npz"),
                     (json.loads(sys.argv[4]), sys.argv[2] + "_read.npz")):
        # the read run replays the port's recording, written meanwhile
        while not os.path.exists(raw["comm_config"]["path"] + ".ready"):
            time.sleep(0.2)
        d = Driver(DriverConfig.from_dict(raw))
        d.step_all()
        d.cleanup()
        np.savez(out, **{f: np.asarray(getattr(d.state, f)) for f in fields})
''')


def _comm_raw(tmp, mode, name):
    raw = yaml_subset.safe_load(open(os.path.join(CONFIG_DIR, f"baroclinic_c12_comm_{mode}.yaml")))
    raw.update(nz=4, minutes=0, seconds=225, precision=64)
    raw["diagnostics_config"].update(path=str(tmp / f"out_{name}"), output_frequency=100)
    raw["performance_config"] = {"collect_performance": False}
    return raw


@pytest.fixture(scope="module", autouse=True)
def crossed(tmp_path_factory):
    """pace_tpu, in a subprocess started with the module, records the write
    config and replays the port's recording; the port records it here."""
    tmp = tmp_path_factory.mktemp("comm")
    t_write = _comm_raw(tmp, "write", "t_write")
    t_write["comm_config"]["path"] = str(tmp / "rec_t.npz")
    j_write = _comm_raw(tmp, "write", "j_write")
    j_write["comm_config"]["path"] = str(tmp / "rec_j.npz")
    j_read = _comm_raw(tmp, "read", "j_read")
    j_read["comm_config"]["path"] = str(tmp / "rec_t.npz")
    open(str(tmp / "rec_j.npz.ready"), "w").close()
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               XLA_FLAGS="--xla_backend_optimization_level=0 "
                         "--xla_llvm_disable_expensive_passes=true")
    fields = list(FIELDS)
    proc = subprocess.Popen(
        [sys.executable, "-c", _PACE_TPU_RUNS, json.dumps(j_write), str(tmp / "jax"),
         json.dumps(fields), json.dumps(j_read)],
        cwd=str(tmp), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rec = Driver(DriverConfig.from_dict(t_write), device="cpu")
        rec.step_all()
        rec.cleanup()
    finally:
        torch.set_num_threads(n)
    open(str(tmp / "rec_t.npz.ready"), "w").close()

    class Runs:
        def __init__(self):
            self.tmp, self.rec, self.fields = tmp, rec, fields
            self._done = None

        def pace_tpu(self):
            if self._done is None:
                out, _ = proc.communicate(timeout=600)
                assert proc.returncode == 0, out[-4000:]
                self._done = (np.load(str(tmp / "jax_write.npz")),
                              np.load(str(tmp / "jax_read.npz")))
            return self._done

    yield Runs()
    if proc.poll() is None:
        proc.kill()


def _hold(state, ref, fields, label):
    for f in fields:
        a = getattr(state, f).numpy()[..., H:-H, H:-H]
        b = np.asarray(ref[f])[..., H:-H, H:-H]
        scale = max(float(np.abs(b).max()), 1e-300)
        err = float(np.abs(a - b).max())
        assert err <= 1e-12 * scale, f"{label} {f}: {err:.3e} of scale {scale:.3e}"


def test_comm_write_then_read_is_bit_identical(crossed, tmp_path):
    """The port's read config replays the port's recording: the state of
    the write run, bit for bit, with the recording used up."""
    raw = _comm_raw(tmp_path, "read", "t_read")
    raw["comm_config"]["path"] = str(crossed.tmp / "rec_t.npz")
    d = Driver(DriverConfig.from_dict(raw), device="cpu")
    assert isinstance(d.halo, tst.ReplayHalo)
    d.step_all()
    d.cleanup()
    assert d.halo._i == len(d.halo._ops) == 88
    for f in crossed.fields:
        assert torch.equal(getattr(d.state, f), getattr(crossed.rec.state, f)), f


def test_recordings_cross_between_the_packages(crossed, tmp_path):
    """pace_tpu's recording replays in the port, and the port's in pace_tpu:
    the same tags, and each replay ends within 1e-12 of the recording run."""
    j_write, j_read = crossed.pace_tpu()
    with np.load(str(crossed.tmp / "rec_j.npz")) as a, np.load(str(crossed.tmp / "rec_t.npz")) as b:
        assert [str(x) for x in a["ops"]] == [str(x) for x in b["ops"]]
    raw = _comm_raw(tmp_path, "read", "t_read_j")
    raw["comm_config"]["path"] = str(crossed.tmp / "rec_j.npz")
    d = Driver(DriverConfig.from_dict(raw), device="cpu")
    d.step_all()
    d.cleanup()
    assert d.halo._i == len(d.halo._ops)
    _hold(d.state, j_write, crossed.fields, "the port replaying pace_tpu's recording")
    _hold(crossed.rec.state, j_read, crossed.fields, "pace_tpu replaying the port's recording")
