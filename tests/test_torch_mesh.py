"""The port's mesh on torch.distributed against pace_tpu's mesh utilities and
the port's own single-process run.

- ``layout_for``, ``gather_tiles``, ``scatter_tiles`` and ``build_plan``
  (the frames, rounds and re-based tables of an exchange) equal to
  ``pace_tpu``'s.
- Three gloo ranks, each a process of its own (``file://`` rendezvous in
  ``tmp_path``, so that parallel test workers share no port; one torch
  thread a rank):
  - the distributed exchange equal to the single-process one, exactly, for
    every stagger, kind, fold and sync and the fold-patch and start/wait
    forms, at layouts [1, 1] and [2, 2] (``tests/main/test_halo_shardmap.py``);
  - the driver at layout [2, 2], npz=4, 2 steps, nonhydrostatic, with
    ``consv_te`` on, within rtol 1e-12 of the single-process port, its
    diagnostics and restart files equal to the single-process run's
    (``tests/main/test_driver_multichip.py``).
- The driver's refusals: a rank count that does not divide the shards, and
  ``pair_debug`` on the mesh.
"""

import json
import os
import subprocess
import sys
import textwrap

import h5py
import numpy as np
import pytest
import torch

from pace_tpu.grid.generation import GridSpec as JGridSpec
from pace_tpu.grid.generation import MetricTerms as JMetricTerms
from pace_tpu.parallel import gather as jgather
from pace_tpu.parallel import mesh as jmesh
from pace_tpu.parallel.halo_shardmap import build_plan as jbuild_plan
from pace_tpu.parallel.halo_slabs import SlabHalo as JSlabHalo
from pace_tpu_torch.driver.config import DriverConfig
from pace_tpu_torch.driver.driver import Driver
from pace_tpu_torch.grid.generation import GridSpec, MetricTerms
from pace_tpu_torch.parallel import gather_tiles, scatter_tiles
from pace_tpu_torch.parallel import mesh as tmesh
from pace_tpu_torch.parallel.halo_shardmap import build_plan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = 3
RANKS = 3
STATE_FIELDS = ("u", "v", "w", "delz", "delp", "pt", "q", "ps", "pe", "peln", "pk", "pkz",
                "omga", "ua", "va", "uc", "vc", "mfxd", "mfyd", "cxd", "cyd")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n_devices,n_tile", [(1, None), (2, None), (3, None), (4, None),
                                              (8, 12), (12, 24), (5, None), (16, 12)])
def test_layout_for_matches_pace_tpu(n_devices, n_tile):
    try:
        want = jmesh.layout_for(n_devices, n_tile)
    except ValueError as e:
        with pytest.raises(ValueError, match="no cube layout"):
            tmesh.layout_for(n_devices, n_tile)
        assert "no cube layout" in str(e)
        return
    assert tmesh.layout_for(n_devices, n_tile) == want


@pytest.mark.parametrize("stagger", ["center", "corner", "x_interface", "y_interface"])
@pytest.mark.parametrize("layout", [(1, 1), (2, 2), (2, 3)])
def test_gather_scatter_tiles_match_pace_tpu(stagger, layout):
    n = 12
    from pace_tpu.parallel.partitioner import CubedSpherePartitioner as JPart
    from pace_tpu_torch.parallel.partitioner import CubedSpherePartitioner as TPart

    jpart, tpart = JPart.from_layout(layout), TPart.from_layout(layout)
    ey, ex = (1 if stagger in ("corner", "y_interface") else 0,
              1 if stagger in ("corner", "x_interface") else 0)
    rng = np.random.default_rng(3)
    tiles = rng.standard_normal((6, 2, n + ey, n + ex))
    want = jgather.scatter_tiles(tiles, jpart, H, stagger)
    got = scatter_tiles(torch.from_numpy(tiles), tpart, H, stagger)
    np.testing.assert_array_equal(got, want)
    shards = rng.standard_normal(want.shape)
    np.testing.assert_array_equal(gather_tiles(torch.from_numpy(shards), tpart, H, stagger),
                                  jgather.gather_tiles(shards, jpart, H, stagger))
    np.testing.assert_array_equal(gather_tiles(got, tpart, H, stagger), tiles)


@pytest.mark.parametrize("layout,n_dev", [((1, 1), 3), ((2, 2), 3), ((2, 2), 8)])
def test_build_plan_matches_pace_tpu(layout, n_dev):
    """The frames, rounds and re-based tables of pace_tpu's shard_map plan,
    for the exchanges of a substep."""
    jslabs = JSlabHalo(JMetricTerms.generate(JGridSpec(n_tile=12, npz=3, layout=layout)).halo)
    tslabs = MetricTerms.generate(GridSpec(n_tile=12, npz=3, layout=layout)).halo.slabs
    S = 6 * layout[0] * layout[1]
    shape = tslabs.halo.shard_shape
    cases = [
        ([("q", shape("center"))], lambda s: [("qx", "q", s._scalar_ops_for("center", "x")),
                                               ("qy", "q", s._scalar_ops_for("center", "y"))]),
        ([("u", shape("y_interface")), ("v", shape("x_interface"))],
         lambda s: [("u", "u", s._build_vector_ops("dgrid", "x")["u"]),
                    ("v", "v", s._build_vector_ops("dgrid", "x")["v"])]),
        ([("u", shape("x_interface")), ("v", shape("y_interface"))],
         lambda s: [("u", "u", s._build_sync_ops("cgrid")["u"]),
                    ("v", "v", s._build_sync_ops("cgrid")["v"])]),
    ]
    for fields, outs in cases:
        want = jbuild_plan(fields, outs(jslabs), S, n_dev)
        got = build_plan(fields, outs(tslabs), S, n_dev)
        assert (got.k, got.total_frame, got.cache_slots) == (want.k, want.total_frame,
                                                            want.cache_slots)
        for a, b in zip(got.fields, want.fields):
            assert a.pieces == b.pieces and a.length == b.length and a.base == b.base
            np.testing.assert_array_equal(a.offset_map, b.offset_map)
        assert len(got.rounds) == len(want.rounds)
        for a, b in zip(got.rounds, want.rounds):
            assert a.perm_pairs == b.perm_pairs
            np.testing.assert_array_equal(a.send_sel, b.send_sel)
            np.testing.assert_array_equal(a.recv_slot, b.recv_slot)
        for a, b in zip(got.outs, want.outs):
            assert a.name == b.name and a.src_field == b.src_field
            for oa, ob in zip(a.ops, b.ops):
                assert oa.dst_rect == ob.dst_rect
                np.testing.assert_array_equal(oa.row_table, ob.row_table)
                np.testing.assert_array_equal(oa.klass_table, ob.klass_table)


# ---------------------------------------------------------------------------
# three ranks, one process each
# ---------------------------------------------------------------------------

_RANK = textwrap.dedent('''
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from pace_tpu_torch.parallel import mesh as M
    rank, world, rdv, out, job = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], \\
        json.loads(sys.argv[5])
    M.initialize_distributed("cpu", init_method=rdv, world_size=world, rank=rank)
    exec(open(job["script"]).read()) if "script" in job else None
''')

_HALO_JOB = textwrap.dedent('''
    from pace_tpu_torch.grid.generation import GridSpec, MetricTerms
    from pace_tpu_torch.parallel.halo_shardmap import DistributedHalo


    def layout_report(layout):
        halo = MetricTerms.generate(GridSpec(n_tile=12, npz=3, layout=layout)).halo
        mesh = M.cube_mesh(halo.n_shards)
        dist_halo, slabs = DistributedHalo(halo.slabs, mesh), halo.slabs
        rng = np.random.default_rng(5)
        S = halo.n_shards

        def field(stagger, lead=(3,)):
            return torch.from_numpy(rng.standard_normal((S,) + lead + halo.shard_shape(stagger)))

        q, qc, qu, qv = (field(s) for s in ("center", "corner", "y_interface", "x_interface"))
        tr = field("center", (2, 3))
        calls = []
        for st, f in (("center", q), ("corner", qc), ("y_interface", qu), ("x_interface", qv)):
            for fold in ("x", "y"):
                calls.append((f"scalar {st} {fold}",
                              lambda h, b, st=st, f=f, fold=fold: h.update_scalar(b(f), st, fold)))
        for kind, (u, v) in (("dgrid", (qu, qv)), ("cgrid", (qv, qu)), ("agrid", (q, q * 2))):
            for fold in ("x", "y"):
                calls.append((f"vector {kind} {fold}", lambda h, b, kind=kind, u=u, v=v, fold=fold:
                              h.update_vector(b(u), b(v), kind, fold)))
            calls.append((f"sync {kind}", lambda h, b, kind=kind, u=u, v=v:
                          h.sync_vector_interfaces(b(u), b(v), kind)))
            calls.append((f"fold pair {kind}", lambda h, b, kind=kind, u=u, v=v:
                          h.update_vector_fold_pair(b(u), b(v), kind)))
            calls.append((f"vector folds {kind}", lambda h, b, kind=kind, u=u, v=v:
                          h.update_vector_folds(b(u), b(v), kind)))
        calls += [
            ("scalars", lambda h, b: h.update_scalars([b(q), b(q * 0.5)])),
            ("scalar folds", lambda h, b: h.update_scalar_folds(b(q))),
            ("scalars folds", lambda h, b: h.update_scalars_folds([b(q), b(q * 3)])),
            ("start scalars folds", lambda h, b: h.start_update_scalars_folds([b(q), b(q * 3)]).wait()),
            ("fold patch", lambda h, b: h.update_scalar_fold_patch(b(q))),
            ("fold patch corner", lambda h, b: h.update_scalar_fold_patch(b(qc), "corner")),
            ("fold patches", lambda h, b: h.update_scalars_fold_patches([b(q), b(q * 2)])),
            ("start fold patches",
             lambda h, b: h.start_update_scalars_fold_patches([b(q), b(q * 2), b(q * 5)]).wait()),
            ("tracer block fold patch", lambda h, b: h.update_scalar_fold_patch(b(tr))),
        ]

        def leaves(x):
            return [y for i in x for y in leaves(i)] if isinstance(x, (list, tuple)) else [x]

        report = {}
        for name, call in calls:
            want = leaves(call(slabs, lambda t: t))
            got = [M.gather_to_root(t, mesh)
                   for t in leaves(call(dist_halo, lambda t: t[mesh.lo:mesh.hi]))]
            if rank == 0:
                report[name] = len(got) == len(want) and all(
                    a.shape == b.shape and torch.equal(a, b) for a, b in zip(got, want))
        return report


    reports = {str(tuple(lay)): layout_report(tuple(lay)) for lay in job["layouts"]}
    if rank == 0:
        json.dump(reports, open(out, "w"))
''')

_DRIVER_JOB = textwrap.dedent('''
    from pace_tpu_torch.driver.config import DriverConfig
    from pace_tpu_torch.driver.driver import Driver
    d = Driver(DriverConfig.from_dict(job["config"]), device="cpu")
    assert d.mesh.k == job["k"] and d.state.u.shape[0] == job["k"]
    d.step_all()
    d.cleanup()
    whole = d._whole(d.state)
    if rank == 0:
        np.savez(open(out, "wb"), **{f: getattr(whole, f).numpy() for f in job["fields"]
                         if getattr(whole, f) is not None})
''')


def _run_ranks(tmp_path, job_code, job, name):
    return _start_ranks(tmp_path, job_code, job, name)()


def _start_ranks(tmp_path, job_code, job, name):
    """Start the ranks; returns the function that waits for them and gives
    ``(out, logs)``."""
    script = tmp_path / f"{name}_job.py"
    script.write_text(job_code)
    job = dict(job, script=str(script))
    out = tmp_path / f"{name}.out"
    rdv = f"file://{tmp_path / (name + '_rendezvous')}"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), str(RANKS), rdv, str(out),
                               json.dumps(job)], cwd=str(tmp_path), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(RANKS)]

    def wait():
        logs = [p.communicate(timeout=300)[0] for p in procs]
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
        return out, logs

    return wait


@pytest.fixture(scope="module")
def halo_reports(tmp_path_factory):
    """Both layouts' reports from one start of the three ranks."""
    out, _ = _run_ranks(tmp_path_factory.mktemp("halo"), _HALO_JOB,
                        {"layouts": [[1, 1], [2, 2]]}, "halo")
    return json.loads(out.read_text())


@pytest.mark.parametrize("layout", [(1, 1), (2, 2)])
def test_distributed_halo_is_the_single_process_exchange(halo_reports, layout):
    report = halo_reports[str(layout)]
    assert len(report) == 32 and all(report.values()), [k for k, v in report.items() if not v]


def _driver_config(tmp_path, mesh, tag):
    return {
        "nx_tile": 12, "nz": 4, "layout": [2, 2], "dt_atmos": 450.0, "seconds": 900,
        "precision": 64, "initialization": {"type": "baroclinic"},
        "mesh_config": {"enabled": mesh},
        "dycore_config": {
            "k_split": 1, "n_split": 2, "hydrostatic": False, "nord": 1, "d4_bg": 0.12,
            "dddmp": 0.5, "do_vort_damp": True, "vtdm4": 0.06, "d_con": 1.0, "fill": True,
            "consv_te": 1.0,
        },
        "diagnostics_config": {"path": str(tmp_path / f"out_{tag}"), "names": ["ps", "ua"],
                               "output_frequency": 1, "output_format": "hdf5"},
        "restart_config": {"save_restart": True, "path": str(tmp_path / f"RESTART_{tag}")},
        "performance_config": {"collect_performance": False},
    }


def test_driver_on_three_ranks_matches_one_process(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    # the ranks run while this process makes the one-process reference
    wait = _start_ranks(tmp_path, _DRIVER_JOB, {
        "config": _driver_config(tmp_path, True, "mesh"), "k": 8, "fields": STATE_FIELDS},
        "driver")
    ref = Driver(DriverConfig.from_dict(_driver_config(tmp_path, False, "single")),
                 device="cpu")
    assert ref.mesh is None
    ref.step_all()
    ref.cleanup()
    fields = [f for f in STATE_FIELDS if getattr(ref.state, f) is not None]
    out, logs = wait()
    assert "backend gloo" in logs[0] and "3 ranks, 24 shards (8 per rank)" in logs[0]
    got = np.load(str(out))
    for f in fields:
        a = getattr(ref.state, f).numpy()[..., H:-H, H:-H]
        b = got[f][..., H:-H, H:-H]
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12 * float(np.abs(a).max()),
                                   err_msg=f)
    # the files: rank 0 writes what the ranks gather, as one process writes it
    for name in ("diagnostics.h5",):
        with h5py.File(tmp_path / "out_single" / name) as a, \
                h5py.File(tmp_path / "out_mesh" / name) as b:
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_allclose(b[k][...], a[k][...], rtol=1e-12, atol=0, err_msg=k)
    with h5py.File(tmp_path / "RESTART_single" / "restart_dycore_state.h5") as a, \
            h5py.File(tmp_path / "RESTART_mesh" / "restart_dycore_state.h5") as b:
        assert sorted(a) == sorted(b) and a.attrs["time_seconds"] == b.attrs["time_seconds"]
        for k in a:
            assert a[k].shape == b[k].shape, k


@pytest.fixture
def gloo_group_of_one(tmp_path, monkeypatch):
    """A one-rank gloo process group in this process, taken down after the
    test; the mesh's recorded rank device restored."""
    import torch.distributed as dist

    monkeypatch.setattr(tmesh, "_RANK_DEVICE", None)
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    for var in ("WORLD_SIZE", "RANK", "LOCAL_WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    yield f"file://{tmp_path / 'rendezvous'}"
    if dist.is_initialized():
        dist.destroy_process_group()


def test_cube_mesh_takes_the_card_initialize_distributed_chose(gloo_group_of_one, monkeypatch):
    """Two ranks to a card (gloo): ``cube_mesh(n)`` with no device is on the
    card ``initialize_distributed('cuda')`` chose, its frames host-staged;
    with no recorded choice it takes the current card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: None)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    backend, staged, dev = tmesh.initialize_distributed("cuda", init_method=gloo_group_of_one,
                                                        world_size=1, rank=0)
    assert (backend, staged, dev) == ("gloo", True, torch.device("cuda", 0))
    mesh = tmesh.cube_mesh(6)
    assert (mesh.device, mesh.backend, mesh.host_staged, mesh.k) == (
        torch.device("cuda", 0), "gloo", True, 6)
    monkeypatch.setattr(tmesh, "_RANK_DEVICE", None)
    mesh = tmesh.cube_mesh(6)
    assert (mesh.device, mesh.host_staged) == (torch.device("cuda", 0), True)
    mesh = tmesh.cube_mesh(6, device="cpu")
    assert (mesh.device, mesh.host_staged) == (torch.device("cpu"), False)


def test_cube_mesh_without_a_card_raises_unless_the_cpu_is_asked(gloo_group_of_one,
                                                                  monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.initialize_distributed("cuda", init_method=gloo_group_of_one, world_size=1, rank=0)
    backend, staged, dev = tmesh.initialize_distributed("cpu", init_method=gloo_group_of_one,
                                                        world_size=1, rank=0)
    assert (backend, staged, dev) == ("gloo", False, torch.device("cpu"))
    assert tmesh.cube_mesh(6).device == torch.device("cpu")
    monkeypatch.setattr(tmesh, "_RANK_DEVICE", None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.cube_mesh(6)


def test_sharded_state_takes_every_tensor_as_shard_leading():
    """``shard_state`` cuts every tensor of a state to the rank's block, and
    one whose leading axis is not the shards raises rather than being kept
    or cut by its length."""
    import dataclasses

    @dataclasses.dataclass
    class St:
        a: torch.Tensor
        b: object = None

    mesh = tmesh.CubeMesh(6, 3, 1, "gloo", torch.device("cpu"))
    s = St(torch.arange(12.0).reshape(6, 2), {"c": torch.arange(6.0)})
    got = tmesh.shard_state(s, mesh)
    assert torch.equal(got.a, s.a[2:4]) and torch.equal(got.b["c"], s.b["c"][2:4])
    with pytest.raises(ValueError, match="leading axis is not the 6 shards"):
        tmesh.shard_state(St(torch.zeros(6, 2), torch.zeros(2, 6)), mesh)
    one = tmesh.CubeMesh(6, 1, 0, "gloo", torch.device("cpu"))
    assert tmesh.gather_state(s, one, names={"a"}) is s


def test_mesh_rejects_indivisible_layout(tmp_path):
    cfg = _driver_config(tmp_path, True, "bad")
    cfg["mesh_config"]["n_devices"] = 5
    with pytest.raises(ValueError, match="devices do not divide"):
        Driver(DriverConfig.from_dict(cfg), device="cpu")


def test_mesh_rejects_pair_debug(tmp_path):
    cfg = _driver_config(tmp_path, True, "pair")
    cfg["pair_debug"] = True
    with pytest.raises(ValueError, match="pair_debug"):
        Driver(DriverConfig.from_dict(cfg), device="cpu")
