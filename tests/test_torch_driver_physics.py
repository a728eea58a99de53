"""The port's driver against pace_tpu's on the CPU, float64: a run with
physics and its restarts, the analytic initial state, and the command line.

``examples/configs/earthlike_c24.yaml`` cut to C12 nz=8 and 2 steps (gray
radiation, the PBL, deep and shallow SAS, the microphysics, ``fv_sg_adj``,
the ``mixed`` surface), with an intermediate restart after step 1 and the
final one, runs once in each package (``Driver(cfg, device="cpu")`` on the
port's side). The final state and surface state agree within 1e-12 of each
field's scale on the compute domain, the diagnostics (``ps``, ``ua``,
``precipitation``, ``tskin``) to one float32 ulp, and the restart files,
the surface's included, hold the same dataset names, dtypes and
attributes. ``pace_tpu``'s step-1 restart, resumed by the port for one step,
agrees with ``pace_tpu``'s second step; the port's own, resumed by the port,
gives its second step bit for bit, surface state included.

The yaml's ``moist: true`` is read and dropped, in both packages: the run
starts with every tracer at zero (ROADMAP queue 3). Last, ``python -m
pace_tpu_torch.driver.run <config> --device cpu`` runs in a subprocess and
writes its outputs, and without ``--device cpu`` it refuses to run on a
machine without a card.
"""

import dataclasses
import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

from pace_tpu.driver.config import DriverConfig as JDriverConfig
from pace_tpu.driver.driver import Driver as JDriver
from pace_tpu_torch.driver.config import DriverConfig, RestartConfig
from pace_tpu_torch.driver.driver import Driver
from pace_tpu_torch.driver.restart import surface_leaves
from pace_tpu_torch.utils import netcdf3, yaml_subset

from .test_torch_driver import (
    ROOT, assert_state_close, h5_layout, region, run_both, with_paths, yaml_config,
)

RESTART_FIELDS = ("u", "v", "delp", "pt", "q", "w", "delz", "phis", "ps", "pe", "peln", "pk",
                  "pkz", "omga")


def earthlike():
    raw = yaml_config("earthlike_c24.yaml", minutes=15)
    raw["restart_config"] = {"save_restart": True, "save_intermediate_restart": True,
                             "intermediate_restart": [1]}
    return raw


def jax_surface_leaves(sfc):
    import jax

    return [(jax.tree_util.keystr(k), np.asarray(v))
            for k, v in jax.tree_util.tree_leaves_with_path(sfc)]


@pytest.fixture(scope="module")
def earthlike_run(tmp_path_factory):
    return run_both(earthlike(), tmp_path_factory, "earthlike")


def test_earthlike_state_matches(earthlike_run):
    j, t = (earthlike_run[i]["driver"] for i in ("jax", "torch"))
    assert t._step_count == j._step_count == 2
    assert t.physics.schemes == tuple(j.physics.schemes)
    assert_state_close(t.state, j.state, {})


def test_earthlike_surface_state_matches(earthlike_run):
    j, t = (earthlike_run[i]["driver"] for i in ("jax", "torch"))
    want = jax_surface_leaves(j.physics.surface_state)
    got = surface_leaves(t.physics.surface_state)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        r = region(w.shape)
        g, w = g.numpy()[r], w[r]
        assert np.isfinite(g).all(), name
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12 * scale, err_msg=name)


def test_earthlike_diagnostics_match(earthlike_run):
    paths = [earthlike_run[i]["tmp"] / "output" / "diagnostics.h5" for i in ("jax", "torch")]
    assert h5_layout(paths[0]) == h5_layout(paths[1])
    with h5py.File(paths[0]) as fj, h5py.File(paths[1]) as ft:
        assert sorted(fj) == ["lat", "lon", "precipitation", "ps", "time", "tskin", "ua"]
        for name in fj:
            got, want = ft[name][...], fj[name][...]
            assert np.array_equal(np.isnan(got), np.isnan(want)), name
            ok = ~np.isnan(want)
            g, w = got[ok].astype(np.float64), want[ok]
            assert (np.abs(g - w) <= np.spacing(np.maximum(np.abs(g), np.abs(w)))).all(), name


@pytest.mark.parametrize("sub", ["", "step_1"])
def test_earthlike_restart_files_match(earthlike_run, sub):
    dirs = [earthlike_run[i]["tmp"] / "RESTART" / sub for i in ("jax", "torch")]
    files = ["restart.yaml", "restart_dycore_state.h5", "restart_surface_state.h5"]
    assert sorted(f for f in os.listdir(dirs[0]) if f != "step_1") == files
    assert sorted(f for f in os.listdir(dirs[1]) if f != "step_1") == files
    for name in files[1:]:
        assert h5_layout(dirs[0] / name) == h5_layout(dirs[1] / name), name
    with h5py.File(dirs[1] / "restart_surface_state.h5") as f:
        assert sorted(f) == sorted([".precip", ".lsm.tskin", ".lsm.stc", ".lsm.smc",
                                    ".lsm.sneqv", ".ice.h_ice", ".ice.h_snow", ".ice.tsfc",
                                    ".ice.sst"])


def _resume_step_1(restart_dir, tmp):
    """One step from a step-1 restart through its restart.yaml, with the
    outputs in ``tmp`` and no restart written."""
    cfg = DriverConfig.from_yaml(str(restart_dir / "restart.yaml"))
    assert cfg.initialization.type == "restart"
    cfg = dataclasses.replace(
        cfg, minutes=0, seconds=450,
        diagnostics_config=dataclasses.replace(cfg.diagnostics_config, path=str(tmp / "out")),
        performance_config=dataclasses.replace(cfg.performance_config,
                                               experiment_name=str(tmp / "exp")),
        restart_config=RestartConfig(),
    )
    d = Driver(cfg, device="cpu")
    assert d.time_seconds == 450.0
    d.step_all()
    return d


def test_port_resumes_pace_tpu_restart_with_surface(earthlike_run, tmp_path):
    """pace_tpu's step-1 restart (state and surface state), resumed by the
    port for one step, agrees with pace_tpu's second step."""
    j = earthlike_run["jax"]["driver"]
    d = _resume_step_1(earthlike_run["jax"]["tmp"] / "RESTART" / "step_1", tmp_path)
    assert_state_close(d.state, j.state, {}, RESTART_FIELDS)
    want = dict(jax_surface_leaves(j.physics.surface_state))
    for name, g in surface_leaves(d.physics.surface_state):
        r = region(want[name].shape)
        scale = float(np.abs(want[name][r]).max())
        np.testing.assert_allclose(g.numpy()[r], want[name][r], rtol=1e-12,
                                   atol=1e-12 * scale, err_msg=name)


def test_port_restart_round_trip_is_bit_exact(earthlike_run, tmp_path):
    """The port's step-1 restart, resumed by the port for one step, gives
    the straight run's second step bit for bit, surface state included."""
    t = earthlike_run["torch"]["driver"]
    d = _resume_step_1(earthlike_run["torch"]["tmp"] / "RESTART" / "step_1", tmp_path)
    for name in RESTART_FIELDS:
        assert torch.equal(getattr(d.state, name), getattr(t.state, name)), name
    got, want = surface_leaves(d.physics.surface_state), surface_leaves(t.physics.surface_state)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        assert torch.equal(g, w), name


def test_moist_is_read_and_dropped(tmp_path):
    """earthlike_c24.yaml asks for ``moist: true``; both packages start dry,
    every tracer zero (ROADMAP queue 3)."""
    raw = with_paths(earthlike(), tmp_path)
    raw["diagnostics_config"]["names"] = []
    assert raw["initialization"]["config"]["moist"] is True
    t = Driver(DriverConfig.from_dict(raw), device="cpu")
    j = JDriver(JDriverConfig.from_dict(raw))
    assert t.config.initialization.config["moist"] is True
    assert not np.asarray(j.state.q).any()
    assert not t.state.q.any()


TINY = {
    "nx_tile": 12, "nz": 4, "dt_atmos": 300.0, "minutes": 10,
    "dycore_config": {"k_split": 1, "n_split": 1, "hydrostatic": True},
    "diagnostics_config": {"path": "output_cli", "names": ["ps", "ua"],
                           "output_format": "netcdf"},
    "performance_config": {"experiment_name": "cli"},
}


def _cli(tmp_path, *args):
    (tmp_path / "tiny.yaml").write_text(yaml_subset.dump(TINY))
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run(
        [sys.executable, "-m", "pace_tpu_torch.driver.run", "tiny.yaml", *args],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )


def test_cli_runs_on_the_cpu_and_writes_outputs(tmp_path):
    out = _cli(tmp_path, "--device", "cpu", "--log-level", "info")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "running 2 steps" in out.stdout
    f = netcdf3.read(str(tmp_path / "output_cli" / "diagnostics.nc"))
    ps = np.asarray(f.variables["ps"].data)
    assert ps.shape == (2, 6, 12, 12) and np.isfinite(ps).all()
    assert (tmp_path / "cli_perf.json").exists()


def test_cli_refuses_without_a_card(tmp_path):
    out = _cli(tmp_path, "--device", "cuda")
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert not (tmp_path / "cli_perf.json").exists()
