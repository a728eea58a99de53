"""The work model against the kernel table of PERF.md: each "Bound ms" at
bench.py's C192 shapes (npz=79, nq=9, S=6, a 3-cell halo, float32) to 4
significant digits, and the launches a step makes at C192 and at the TC's
shapes."""

import pytest

from benchmark import workmodel as wm

C192 = wm.Shapes(S=6, K=79, nq=9, P=198)
TC = wm.Shapes(S=6, K=63, nq=9, P=134)


def ms(bytes_ops):
    return 1e3 * wm.bound_seconds(*bytes_ops)


#: (row of the kernel table, the form, its "Bound ms")
TABLE = [
    ("halo fold patch, the tracer block (6x711 planes)",
     lambda s: (wm.halo_bytes(s, 711, "c") + wm.halo_bytes(s, 711, "pack"), 0), 0.4001),
    ("halo C-grid wind sync, a launch", lambda s: (wm.halo_bytes(s, 79, "xi"), 0), 0.0452),
    ("fvtp2d single, delp hord 6 corner pack", lambda s: wm.fvtp2d_single(s, 79, 6, True), 0.1563),
    ("fvtp2d single, heights K=80 full qy", lambda s: wm.fvtp2d_single(s, 80, 5, False), 0.1807),
    ("fvtp2d multi, 3 fields", lambda s: wm.fvtp2d_multi(s, (6, 6, 6), (True, True, True)), 0.3345),
    ("fvtp2d tracer, nq=9 hord 8", lambda s: wm.fvtp2d_tracer(s, 8), 0.7354),
    ("d2a2c", wm.d2a2c, 0.1878),
    ("c_sw tail", wm.c_sw_tail, 0.5181),
    ("hydro pkz", lambda s: wm.hydro(s, ("pkz",)), 0.0444),
    ("hydro pk, pkz", lambda s: wm.hydro(s, ("pk", "pkz")), 0.0668),
    ("hydro pk, pkz, gz", lambda s: wm.hydro(s, ("pk", "pkz", "gz")), 0.1118),
    ("heights", wm.heights, 0.0449),
    ("updatedz_c", wm.updatedz_c, 0.1126),
    ("flux_height_update", wm.flux_height_update, 0.1355),
    ("sim1", wm.sim1, 0.1781),
    ("pgrad", wm.pgrad, 0.1811),
    ("d_sw tail, nord 3", lambda s: wm.d_sw_tail(s, 3), 0.2926),
    ("remap, one field", lambda s: wm.remap(s, "c"), 0.0893),
    ("remap, the nq=9 block", lambda s: wm.remap(s, "c", 9), 0.4443),
]


@pytest.mark.parametrize("row,form,table_ms", TABLE, ids=[t[0] for t in TABLE])
def test_bound_reproduces_the_kernel_table(row, form, table_ms):
    """The table prints four decimals of a millisecond: four significant
    digits from 0.1 ms up, three below."""
    assert round(ms(form(C192)), 4) == table_ms


def test_c192_launches_per_step():
    got = wm.launches(wm.StepConfig(k_split=7, n_split=8), C192, [1] * 7)
    assert got == {"halo": 2620, "fvtp2d": 112, "fvtp2d_multi": 56, "fvtp2d_tracer": 7,
                   "d2a2c": 57, "c_sw_tail": 56, "hydro": 112, "heights": 224, "updatedz_c": 56,
                   "flux_height_update": 56, "sim1": 112, "pgrad": 56, "d_sw_tail": 56,
                   "remap": 42}


def test_tc_launches_per_step():
    """PERF.md's launch counts on the TC path (per step call: halo 566,
    fvtp2d 24, tracer 2, d2a2c 13, hydro 24, heights 48, sim1 24, the other
    seven rows 12 each)."""
    got = wm.launches(wm.StepConfig(k_split=2, n_split=6, nord=2), TC, [1, 1])
    assert got == {"halo": 566, "fvtp2d": 24, "fvtp2d_tracer": 2, "d2a2c": 13, "hydro": 24,
                   "heights": 48, "sim1": 24, "fvtp2d_multi": 12, "c_sw_tail": 12,
                   "d_sw_tail": 12, "updatedz_c": 12, "flux_height_update": 12, "pgrad": 12,
                   "remap": 12}


def test_hydrostatic_launches_per_step():
    """chip_smoke.py's HYDROSTATIC_STEP_LAUNCHES at k_split=1, n_split=5."""
    got = wm.launches(wm.StepConfig(k_split=1, n_split=5, hydrostatic=True, nord=1), C192, [1])
    assert got == {"halo": 5 * 35 + 2 + 4 + 2, "d2a2c": 6, "c_sw_tail": 5, "hydro": 10,
                   "fvtp2d": 5, "fvtp2d_multi": 5, "d_sw_tail": 5, "fvtp2d_tracer": 1,
                   "remap": 4}


def test_step_bound_counts_work_not_launches():
    """More tracer sub-cycles add the tracer block's work and its exchanges;
    every operator's bound is positive and bytes bound them all."""
    cfg = wm.StepConfig(k_split=7, n_split=8)
    one, two = wm.step_bound(cfg, C192, [1] * 7), wm.step_bound(cfg, C192, [2] * 7)
    assert two["fvtp2d_tracer"] == pytest.approx(2 * one["fvtp2d_tracer"])
    assert two["halo"] > one["halo"]
    assert all(v > 0 for v in one.values())
    for forms in wm.calls(cfg, C192, [1] * 7).values():
        for _n, (b, o) in forms:
            assert b / wm.PEAK_BYTES_PER_S >= o / wm.peaks.PEAK_F32_OPS_PER_S


def test_a_rank_bound_is_the_cube_bound_over_the_ranks():
    """C192 at layout [2, 2] (24 shards of 96 x 96) on four ranks: a rank's
    block of six shards is bound by a quarter of the whole cube's work."""
    cfg = wm.StepConfig(k_split=7, n_split=8)
    cube = wm.step_bound(cfg, wm.Shapes(S=24, K=79, nq=9, P=102), [1] * 7)
    rank = wm.step_bound(cfg, wm.Shapes(S=6, K=79, nq=9, P=102), [1] * 7)
    assert set(rank) == set(cube)
    for op in cube:
        assert rank[op] == pytest.approx(cube[op] / 4, rel=1e-12), op
    assert sum(rank.values()) == pytest.approx(sum(cube.values()) / 4, rel=1e-12)


def test_the_metrics_count_the_rank_block():
    """The readers' shapes come from the state the rank holds: its block of
    the shards, not the cube."""
    from types import SimpleNamespace

    import torch

    from benchmark import harness

    block = SimpleNamespace(delp=torch.empty(6, 79, 102, 102), q=torch.empty(6, 9, 79, 102, 102))
    driver = SimpleNamespace(state=block, config=SimpleNamespace(
        dycore_config=wm.StepConfig(k_split=7, n_split=8)))
    ctx = harness._context(driver, harness.Window(), 3)
    assert ctx.shapes == wm.Shapes(S=6, K=79, nq=9, P=102)
