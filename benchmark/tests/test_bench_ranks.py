"""Runs of a cell on two ranks on the CPU (gloo), through the launcher a
cell with ``chips`` 2 or more takes: correct, with the numbers of a run in
one process; each fault not correct; a rank that raises ends the run with no
result and no wait. At C12 with two substeps a step, six shards over two
ranks; each rank and the run in this process on one thread (the CPU's plain
path gives the same bits on one thread)."""

import math
import sys
import time

import pytest
import torch

from benchmark import harness, ranks
from benchmark.tests import faults

CELL = "tc_c128"
SMALL = {"nx_tile": 12, "nz": 8, "diagnostics_config": {"output_frequency": 3},
         "dycore_config": {"n_split": 2}}
SEED = 2147483659


def launch(fault=None):
    entry = None if fault is None else [sys.executable, "-m", "benchmark.tests.faulty_rank",
                                        fault]
    return ranks.launch(CELL, SEED, 0.0, False, 2, device="cpu", shrink=SMALL, entry=entry)


@pytest.fixture
def one_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def one_process():
    return harness.run_cell(CELL, SEED, 0.0, False, device="cpu", shrink=SMALL)


def assert_same_numbers(a, b):
    """The largest gaps bit for bit; the rms gaps, whose sums the ranks add
    in another order, to rounding."""
    assert list(a["checks"]) == list(b["checks"])
    for name, c in a["checks"].items():
        x, y = c["value"], b["checks"][name]["value"]
        if "_rms." in name and x is not None and y is not None:
            assert x == pytest.approx(y, rel=1e-12, abs=1e-300), name
        else:
            assert x == y, name


def not_correct(out):
    return out["correct"] is False and any(
        c["value"] is None or c["value"] > c["limit"] for c in out["checks"].values())


def test_two_ranks_match_one_process(one_thread):
    two = launch()
    assert two is not None
    assert list(two) == ["correct", "attempted", "failed", "metrics", "device", "ranks", "checks"]
    assert two["correct"] is True, two["checks"]
    assert two["device"]["count"] == 2 and [r["rank"] for r in two["ranks"]] == [0, 1]
    assert set(two["metrics"]) == {"sypd", "peak_mem_gb", "setup_s"}
    assert_same_numbers(two, one_process())


def test_altered_answer_reads_as_in_one_process(one_thread, monkeypatch):
    """A fault on the last shard (rank 1's) gives gaps that are not 0, and
    the ranks' combined numbers are the single process's."""
    two = launch("answer altered")
    faults.plant("answer altered", monkeypatch.setattr)
    one = one_process()
    assert two is not None and not_correct(two) and not_correct(one)
    assert two["checks"]["step.pt"]["value"] > 0
    assert_same_numbers(two, one)


@pytest.mark.parametrize("fault", ["exchange left out", "half the shards left out",
                                   "receive slots swapped"])
def test_fault_is_not_correct_on_ranks(one_thread, fault):
    """Each fault of the program on a mesh. The reference's exchange shares
    no code with the program's schedule between ranks, so a fault there
    (two received frames in each other's slots) is caught too."""
    out = launch(fault)
    assert out is not None and not_correct(out)


def test_a_rank_that_raises_ends_the_run(one_thread, capfd):
    t0 = time.perf_counter()
    assert launch("rank 1 raises") is None
    # the run ends when rank 1 does, well inside the process group's timeout
    assert time.perf_counter() - t0 < ranks.TIMEOUT_S / 4
    out, err = capfd.readouterr()
    assert out == ""
    assert "a fault planted on rank 1" in err and "exited with 1: ending the others" in err


def test_a_layout_that_does_not_split_is_refused():
    with pytest.raises(ValueError, match="do not divide over 4 ranks"):
        harness.cell_dict(CELL, SMALL, 4)
    assert harness.cell_dict(CELL, SMALL, 2)["mesh_config"] == {"enabled": True, "n_devices": 2}
    assert harness.cell_dict(CELL, {"layout": [2, 2]}, 4)["mesh_config"]["n_devices"] == 4
    assert "mesh_config" not in harness.cell_dict(CELL, SMALL)


def test_combined_parts_are_the_whole_cube_gaps():
    """Gap parts of blocks of shards, combined, give the whole array's gaps."""
    from benchmark import check

    gen = torch.Generator().manual_seed(5)
    ref = torch.rand((6, 4, 10, 10), generator=gen, dtype=torch.float64)
    prog = ref + 1e-6 * torch.rand((6, 4, 10, 10), generator=gen, dtype=torch.float64)
    prog[4, 2, 5, 5] = ref[4, 2, 5, 5] + 1e-3
    for gap, parts in ((check.field_gap, check.gap_parts),
                       (check.field_rms_gap, check.rms_parts)):
        blocks = [parts(prog[lo:lo + 2], ref[lo:lo + 2], 3) for lo in (0, 2, 4)]
        whole = check.finish(check.combine(blocks))
        assert whole == pytest.approx(gap(prog, ref, 3), rel=1e-12)
    bad = prog.clone()
    bad[5, 0, 4, 4] = math.nan
    blocks = [check.gap_parts(bad[lo:lo + 3], ref[lo:lo + 3], 3) for lo in (0, 3)]
    assert check.finish(check.combine(blocks)) == math.inf
