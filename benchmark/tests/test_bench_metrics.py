"""Each per-layer metric reader on a synthetic list of device operations."""

import pytest

from benchmark import harness, registry, trace
from benchmark import workmodel as wm

SHAPES = wm.Shapes(S=6, K=79, nq=9, P=198)
CFG = wm.StepConfig(k_split=7, n_split=8)


def op(name, start_ms, dur_ms, *scopes):
    return trace.DeviceOp(name, 1e3 * start_ms, 1e3 * dur_ms, tuple(scopes))


# two steps of 100 ms of host wall each; times in ms
OPS = [
    op("void halo_gather<float>(float const*, int)", 0, 10, "bench.step", "DynCore", "HaloExchange"),
    op("void sim1_kernel<float>(Args<float>)", 10, 20, "bench.step", "DynCore", "RiemannC"),
    op("void at::native::elementwise_kernel<128, 4>(int)", 30, 30, "bench.step", "DynCore"),
    op("void fvtp2d_tracer_kernel<float, 8>(...)", 70, 10, "bench.step", "TracerAdvection"),
    op("void remap_kernel<float>(...)", 85, 5, "bench.step", "Remapping"),
    op("Memcpy DtoH (Device -> Pageable)", 95, 5, "bench.step", "bench.end_of_step"),
    op("void halo_gather<float>(float const*, int)", 100, 10, "bench.step", "DynCore", "HaloExchange"),
    op("void at::native::vectorized_elementwise_kernel<4>(int)", 150, 20, "bench.step"),
]


def ctx(ops=OPS, walls=(), window=None):
    window = window or harness.Window(steps=4, seconds=0.8, issue_seconds=0.2,
                                      subcycles=[[1] * 7] * 4)
    return harness.MetricContext(ops=list(ops), profiled_steps=2, stretch_seconds=0.2,
                                 profiled_subcycles=[[1] * 7, [1] * 7], window=window,
                                 step_config=CFG, shapes=SHAPES, physics_walls=list(walls))


def read(name, c):
    return registry.metric_reader(name).read(c)


def test_device_idle_pct():
    # busy 110 ms of the stretch's 200 ms
    assert read("device_idle_pct", ctx()) == pytest.approx(100 * (1 - 0.110 / 0.2))


def test_stage_metrics():
    c = ctx()
    assert read("halo_ms", c) == pytest.approx(10.0)      # 20 ms over 2 steps
    assert read("acoustic_ms", c) == pytest.approx(25.0)  # sim1 and the glue in DynCore
    assert read("tracer_ms", c) == pytest.approx(5.0)
    assert read("remap_ms", c) == pytest.approx(2.5)


def test_glue_ms():
    assert read("glue_ms", ctx()) == pytest.approx((30 + 20) / 2)


def test_nccl_waits_are_no_work():
    """On a mesh NCCL's kernels spin while they wait for a peer: the harness
    takes them out before any reader sees the trace, and counts them apart,
    so that no metric reads a wait as work or as busy time."""
    nccl = [op("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)", 110, 38, "bench.step",
               "DynCore", "HaloExchange"),
            op("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)", 60, 9,
               "bench.step", "TracerAdvection", "HostSync.tracer_subcycles")]
    work, waits = trace.split_nccl(OPS + nccl)
    assert work == OPS and waits == pytest.approx(0.047)
    assert trace.split_nccl(OPS) == (OPS, 0.0)
    c = ctx(work)
    for name in ("glue_ms", "halo_ms", "device_idle_pct", "tracer_ms"):
        assert read(name, c) == read(name, ctx()), name


def test_kernels_roofline_pct_counts_only_operators_in_the_trace():
    per_step = wm.step_bound(CFG, SHAPES, [1] * 7)
    bound = 2 * sum(per_step[k] for k in ("halo", "sim1", "fvtp2d_tracer", "remap"))
    assert read("kernels_roofline_pct", ctx()) == pytest.approx(100 * bound / 0.055)


def test_step_mfu_and_host_issue():
    c = ctx()
    assert read("step_mfu", c) == pytest.approx(
        100 * 4 * sum(wm.step_bound(CFG, SHAPES, [1] * 7).values()) / 0.8)
    assert read("host_issue_ms", c) == pytest.approx(50.0)


def test_physics_wall_ms():
    assert read("physics_wall_ms", ctx(walls=(0.5, 0.7))) == pytest.approx(600.0)
    assert read("physics_wall_ms", ctx()) is None


@pytest.mark.parametrize("name", ["device_idle_pct", "kernels_roofline_pct", "glue_ms", "halo_ms",
                                  "acoustic_ms", "tracer_ms", "remap_ms"])
def test_nothing_to_read_gives_none(name):
    """A trace with no device operation (the CPU) reads nothing: never a 0
    share."""
    assert read(name, ctx(ops=[])) is None


def test_breakdown_helpers():
    top = trace.top_ops(OPS, 3)
    assert top[0] == ("void at::native::elementwise_kernel<128, 4>(int)", pytest.approx(0.030))
    gaps = dict(trace.idle_gaps(OPS))
    # 60-70 before the tracer kernel, 80-85, 110-150 inside bench.step
    assert gaps["TracerAdvection"] == pytest.approx(0.010)
    assert gaps["Remapping"] == pytest.approx(0.005)
    assert gaps["bench.step"] == pytest.approx(0.040)
    assert trace.busy_seconds(OPS) == pytest.approx(0.110)
