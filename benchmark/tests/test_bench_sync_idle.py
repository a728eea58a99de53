"""The reader of ``sync_idle_ms`` on synthetic device operations: the idle
gaps that begin at the end of an operation launched inside a ``HostSync.*``
range."""

import pytest

from benchmark import harness, registry, trace
from benchmark import workmodel as wm


def op(name, start_ms, dur_ms, *scopes):
    return trace.DeviceOp(name, 1e3 * start_ms, 1e3 * dur_ms, tuple(scopes))


# two steps; times in ms
OPS = [
    op("void sim1_kernel<float>(Args<float>)", 0, 20, "mainloop", "FVDynamics", "DynCore"),
    # the sub-cycle count's copy to the host: the card idles 30-34
    op("Memcpy DtoH (Device -> Pageable)", 29, 1, "mainloop", "FVDynamics", "TracerAdvection",
       "HostSync.tracer_subcycles"),
    op("void fvtp2d_tracer_kernel<float, 8>(...)", 34, 10, "mainloop", "FVDynamics",
       "TracerAdvection"),
    # a gap after an operation outside every HostSync range: not counted
    op("void remap_kernel<float>(...)", 50, 5, "mainloop", "FVDynamics", "Remapping"),
    # a blocking copy to the card that overlaps the work before it ends
    # no gap; the one that begins at its end (61-63) counts
    op("Memcpy HtoD (Pageable -> Device)", 54, 7, "mainloop", "FVDynamics", "Remapping",
       "HostSync.scalar_like"),
    op("void at::native::elementwise_kernel<128, 4>(int)", 63, 2, "mainloop", "FVDynamics"),
    op("Memcpy DtoH (Device -> Pageable)", 70, 1, "Diagnostics", "HostSync.diagnostics"),
    op("void halo_gather<float>(float const*, int)", 80, 10, "mainloop", "FVDynamics",
       "DynCore", "HaloExchange"),
]


def ctx(ops):
    return harness.MetricContext(ops=list(ops), profiled_steps=2, stretch_seconds=0.1,
                                 profiled_subcycles=[[1], [1]], window=harness.Window(),
                                 step_config=wm.StepConfig(k_split=1, n_split=1),
                                 shapes=wm.Shapes(S=6, K=8, nq=1, P=18), physics_walls=[])


def read(c):
    return registry.metric_reader("sync_idle_ms").read(c)


def test_reads_the_gaps_that_begin_in_a_host_sync():
    # 30-34, 61-63 and 71-80 begin at the end of an operation launched in a
    # HostSync range; 20-29, 44-50 and 65-70 do not
    assert read(ctx(OPS)) == pytest.approx((4 + 2 + 9) / 2)


def test_no_gap_reads_zero():
    assert read(ctx(OPS[:2])) == pytest.approx(0.0)


@pytest.mark.parametrize("ops", [[], [o for o in OPS if not any(
    s.startswith("HostSync.") for s in o.scopes)]], ids=["no operations", "no HostSync range"])
def test_nothing_to_read_gives_none(ops):
    assert read(ctx(ops)) is None
