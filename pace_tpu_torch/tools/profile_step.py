"""Profile one dycore step: device time per stage and per kernel.

Port of ``pace_tpu.tools.profile_step``: ``torch.profiler`` over one step
(after one unprofiled step), with the stages of ``driver/stage_profile.py``
(HaloExchange, DynCore, TracerAdvection, Remapping)::

    python -m pace_tpu_torch.tools.profile_step --n-tile 192 --npz 79 [--steps 1]
        [--physics] [--hydrostatic] [--top 25] [--device cuda|cpu]
        [--k-split 2] [--n-split 4]

Prints the total, the device seconds of each stage and the kernels with the
most device time (name, total, launches). On the CPU a trace holds no
device events: the stage table is empty, and the operator table lists host
time instead. Writes nothing.
"""

from __future__ import annotations

import argparse
import collections


def _case(n_tile, npz, hydrostatic, physics, device, k_split=2, n_split=4):
    import torch

    from ..grid.generation import GridSpec, MetricTerms
    from ..grid.grid_data import GridData
    from ..models.fv3.dycore import DynamicalCore, DynamicalCoreConfig
    from ..models.fv3.state import DycoreState

    mt = MetricTerms.generate(GridSpec(n_tile=n_tile, npz=npz, layout=(1, 1)))
    grid = GridData.from_metric_terms(mt, device=device, dtype=torch.float32)
    state = DycoreState.from_baroclinic_init(mt, perturbation=True, device=device,
                                             dtype=torch.float32)
    cfg = DynamicalCoreConfig(
        npz=npz, k_split=k_split, n_split=n_split, hydrostatic=hydrostatic,
        nord=3, d4_bg=0.15, d2_bg_k1=0.2, d2_bg_k2=0.1, dddmp=0.5,
        do_vort_damp=True, vtdm4=0.06, d_con=1.0, fill=True,
        tau=10.0, rf_fast=True, rf_cutoff=3000.0, n_sponge=8,
    )
    core = DynamicalCore(grid, mt.halo, cfg, 450.0)
    phys = None
    if physics:
        from ..models.shield.physics import Physics

        phys = Physics(grid, ("GFS_microphysics", "GFS_PBL"), 450.0, halo=mt.halo)

    def one(st):
        st = core.step_dynamics(st)
        return phys(st) if phys is not None else st

    return one, state


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m pace_tpu_torch.tools.profile_step")
    p.add_argument("--n-tile", type=int, default=192)
    p.add_argument("--npz", type=int, default=79)
    p.add_argument("--steps", type=int, default=1)
    p.add_argument("--physics", action="store_true")
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--hydrostatic", action="store_true")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the step runs (default: the card)")
    p.add_argument("--k-split", type=int, default=2, help="remaps a step")
    p.add_argument("--n-split", type=int, default=4, help="acoustic substeps a remap")
    args = p.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..driver.stage_profile import STAGES, attribute_stages, kernel_scopes
    from ..dtypes import resolve_device

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    one, st = _case(args.n_tile, args.npz, args.hydrostatic, args.physics, device,
                    args.k_split, args.n_split)

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    st = one(st)  # the first step builds the kernels and the plans
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        for _ in range(args.steps):
            st = one(st)
        sync()
    events = prof.events()

    scoped = kernel_scopes(events)
    total_ms = sum(d for d, _ in scoped) / 1e3
    print(f"{args.steps} step(s) at C{args.n_tile} npz={args.npz} on {device}: "
          f"{total_ms:.3f} ms device time in {len(scoped)} device events")
    print("\n--- per stage ---")
    stages = attribute_stages(scoped, ("HaloExchange",) + STAGES)
    if not stages:
        print("no device events (the CPU): no stage times")
    for stage, sec in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"{sec * 1e3:9.3f} ms  {stage}")

    if on_card:
        print("\n--- by kernel (device time, launches) ---")
        agg_t, agg_n = collections.Counter(), collections.Counter()
        for e in events:
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
                agg_t[e.name] += e.time_range.elapsed_us()
                agg_n[e.name] += 1
        for name, t in agg_t.most_common(args.top):
            print(f"{t / 1e3:9.3f} ms  x{agg_n[name]:5d}  {name[:100]}")
    else:
        print("\n--- by operator (host self time, calls) ---")
        rows = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
        for a in rows[:args.top]:
            print(f"{a.self_cpu_time_total / 1e3:9.3f} ms  x{a.count:5d}  {a.key[:100]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
