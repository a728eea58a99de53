"""Driver: builds the grid, state, dycore and physics, runs the timestep loop.

Port of ``pace_tpu.driver.driver`` (reference role: ``Driver``: ``__init__``
builds the grid, state, dycore, physics and diagnostics; ``step_all`` runs
the mainloop with per-step diagnostics, safety checks, performance
collection and intermediate restarts; ``cleanup`` writes the final outputs).
Each step runs eagerly on the driver's device, ``cuda`` unless the caller
asks for ``cpu``; the dtype comes from ``precision`` (64: float64, else
float32), with no process-wide switch.

``debug_checks`` runs the dycore with the per-stage sanitizer
(:mod:`pace_tpu_torch.testing.sanitizer`), which raises at the first stage
with a non-finite value, a non-positive ``delp`` or a tracer below its
floor. ``pair_debug`` steps a replica of the dycore beside the model: the
primary records every stage into a ``SnapshotCheckpointer``, the replica
compares its own stages with the recording through a
``PairStageComparator``, and the first difference raises, naming the
stage, the variable and the hit; the replica runs the dycore alone, as
``pace_tpu``'s does. Both take each stage's variables to the host.

``comm_config`` picks the halo backend: the exchange, or a stand-in for it
from ``parallel/strategies.py`` (``null`` fills the ghosts with a constant,
``write`` records every exchange and saves the recording at the end of
``step_all``, ``read`` replays one).

``mesh_config.enabled`` splits the run over the ranks of torch.distributed
(``parallel/mesh.py``; ``torchrun --nproc-per-node N python -m
pace_tpu_torch.driver.run <yaml>``): each rank steps its block of the
shards with the distributed exchange (``parallel/halo_shardmap.py``), and
every rank runs every step and exchange; the diagnostics and restarts are
gathered, and rank 0 writes them, the same files as a single-process run.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import numpy as np
import torch

from ..dtypes import resolve_device
from ..grid.grid_data import GridData
from ..models.fv3.dycore import DynamicalCore
from ..utils.logging import get_logger
from .config import DriverConfig
from .fortran_restart import coupler_elapsed_seconds, is_fortran_restart
from .performance import Timer
from .restart import (
    has_surface_restart, load_surface_restart, restart_time, save_restart,
    save_surface_restart,
)
from .safety_checks import SafetyChecker

logger = get_logger()

#: the physics stages the stage profile reads (pace_tpu's list)
PHYSICS_STAGES = ("Radiation", "Surface", "PBL", "DeepConvection", "ShallowConvection",
                  "Microphysics")


class Driver:
    def __init__(self, config: DriverConfig, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        if config.comm_config.type not in ("exchange", "null", "write", "read"):
            raise ValueError(f"unknown comm type {config.comm_config.type!r}")
        dtype = torch.float64 if config.precision == 64 else torch.float32
        self.dtype = dtype
        self.mesh = self._build_mesh() if config.mesh_config.enabled else None

        logger.info("generating grid (C%d, nz=%d)", config.nx_tile, config.nz)
        self.metric_terms = config.grid_config.get_metric_terms(
            config.nx_tile, config.nz, config.layout
        )
        self.grid_data = GridData.from_metric_terms(self.metric_terms, device=self.device,
                                                    dtype=dtype)
        self.halo = self.metric_terms.halo
        if self.mesh is not None:
            from ..parallel.halo_shardmap import DistributedHalo
            from ..parallel.mesh import shard_state

            self.grid_data = shard_state(self.grid_data, self.mesh)
            self.halo = DistributedHalo(self.metric_terms.halo.slabs, self.mesh)

        # the halo backend: null, write and read stand in for the exchange
        # (parallel/strategies.py); a recording run and its replay make no
        # exchange outside the mainloop's steps, so they skip the stage
        # profile's extra step
        self._recorded_exchanges = False
        comm = config.comm_config
        if comm.type == "null":
            from ..parallel.strategies import ConstantFillHalo

            self.halo = ConstantFillHalo(self.halo, comm.fill_value)
        elif comm.type == "write":
            from ..parallel.strategies import RecordingHalo

            self.halo = RecordingHalo(self.halo)
            self._recorded_exchanges = True
        elif comm.type == "read":
            from ..parallel.strategies import ReplayHalo

            self.halo = ReplayHalo(comm.path, self.metric_terms.halo)
            self._recorded_exchanges = True

        logger.info("initializing state (%s)", config.initialization.type)
        self.state = config.initialization.get_dycore_state(
            self.metric_terms, self.device, dtype
        )
        if self.mesh is not None:
            from ..parallel.mesh import shard_state

            self.state = shard_state(self.state, self.mesh)
        checkpointer = None
        if config.debug_checks:
            from ..testing.sanitizer import make_sanitizer

            checkpointer = make_sanitizer()
            logger.info("debug_checks: per-stage sanitizer active")
        # pair_debug: a second dycore steps a replica of the state, and its
        # stages are compared with the primary's recording of the same step
        self.dycore_pair = None
        self._pair_cmp = None
        if config.pair_debug:
            from ..testing.checkpointer import PairStageComparator, SnapshotCheckpointer

            checkpointer = SnapshotCheckpointer()
            self._pair_cmp = PairStageComparator(checkpointer)
            self.dycore_pair = DynamicalCore(self.grid_data, self.halo, config.dycore_config,
                                             config.dt_atmos, checkpointer=self._pair_cmp)
            self.state_pair = self.state
        self.dycore = DynamicalCore(
            self.grid_data, self.halo, config.dycore_config, config.dt_atmos,
            checkpointer=checkpointer,
        )

        self.physics = None
        run_physics = (
            config.physics_config.schemes
            and not config.dycore_only
            and not config.disable_step_physics
        )
        # the dry convective adjustment runs even with dycore_only
        if run_physics or config.dycore_config.fv_sg_adj > 0:
            self.physics = self._build_physics(run_physics)
            self._maybe_load_surface()
            # the surface state exists before the first physics call, so
            # that step-0 diagnostics can read precipitation, tskin, ...
            if (self.physics._surface is not None
                    and self.physics.surface_state is None):
                self.physics.surface_state = self.physics._surface.init(
                    self._whole_shape(self.state.ps), self.state.ps.dtype, device=self.device
                )

            if self.mesh is not None and self.physics.surface_state is not None:
                from ..parallel.mesh import shard_state

                self.physics.surface_state = shard_state(self.physics.surface_state,
                                                         self.mesh)

        # on a mesh, rank 0 writes what the ranks gather
        if self._writes:
            self.diagnostics = config.diagnostics_config.diagnostics_factory(
                self.metric_terms, self.metric_terms.spec.n_halo
            )
        else:
            from .diagnostics import NullDiagnostics

            self.diagnostics = NullDiagnostics()
        self.diagnostics.store_grid(self.metric_terms)

        self.performance = config.performance_config.build()
        self.timer = Timer()

        self.safety_checker = SafetyChecker()
        for chk in config.safety_checks:
            self.safety_checker.register_variable(
                chk.variable,
                chk.minimum_value,
                chk.maximum_value,
                chk.compute_domain_only,
            )

        # a restart resumes the model clock (the diurnal forcing and the
        # output times continue); a Fortran restart's clock is coupler.res's
        # current time less its start time
        self.time_seconds = 0.0
        init = config.initialization
        if init.type in ("restart", "fortran_restart"):
            icfg = init.config or {}
            path = icfg.get("path", "RESTART")
            self.time_seconds = float(icfg.get("start_time_seconds", 0.0))
            if not self.time_seconds:
                try:
                    if init.type == "fortran_restart" or is_fortran_restart(path):
                        self.time_seconds = coupler_elapsed_seconds(path)
                    else:
                        self.time_seconds = restart_time(path)
                except (OSError, KeyError):
                    pass
        self._step_count = 0

    def _build_physics(self, run_physics: bool):
        from ..models.shield.band_radiation import BandRadiationConfig
        from ..models.shield.held_suarez import HeldSuarezConfig
        from ..models.shield.microphysics import MicrophysicsConfig
        from ..models.shield.pbl import PBLConfig
        from ..models.shield.physics import Physics
        from ..models.shield.radiation import GrayRadiationConfig
        from ..models.shield.sas import DeepConvectionConfig, ShallowConvectionConfig
        from ..models.shield.surface import SurfaceConfig
        from ..utils.registry import from_dict

        config = self.config
        pc = config.physics_config
        # the saturation-adjustment family lives in dycore_config (shared
        # with the dycore's saturation adjustment); physics_config's
        # microphysics keys override it
        shared = {
            k: getattr(config.dycore_config, k)
            for k in (
                "tau_l2v", "tau_v2l", "tau_i2s", "tau_g2v", "ql_gen",
                "ql_mlt", "qs_mlt", "qi_lim", "dw_ocean", "dw_land",
                "icloud_f", "do_qa",
            )
        }
        return Physics(
            self.grid_data,
            pc.schemes if run_physics else (),
            config.dt_atmos,
            fv_sg_adj=config.dycore_config.fv_sg_adj,
            config=from_dict(MicrophysicsConfig, {**shared, **(pc.microphysics or {})}),
            pbl_config=from_dict(PBLConfig, pc.pbl or {}),
            radiation_config=from_dict(GrayRadiationConfig, pc.radiation or {}),
            sas_config=from_dict(ShallowConvectionConfig, pc.shallow_convection or {}),
            deep_config=from_dict(DeepConvectionConfig, pc.deep_convection or {}),
            surface_config=from_dict(SurfaceConfig, pc.surface or {}),
            held_suarez_config=from_dict(HeldSuarezConfig, pc.held_suarez or {}),
            band_radiation_config=from_dict(BandRadiationConfig, pc.band_radiation or {}),
            halo=self.halo,
        )

    def _build_mesh(self):
        """This rank's block of the shards, after ``pace_tpu``'s refusals: a
        rank count that does not divide the shards, and ``pair_debug``."""
        import torch.distributed as dist

        from ..parallel import mesh as M

        cfg = self.config
        ly, lx = cfg.layout
        n_shards = 6 * ly * lx
        world = (dist.get_world_size() if dist.is_initialized()
                 else int(os.environ.get("WORLD_SIZE", "1")))
        n_dev = cfg.mesh_config.n_devices or world
        if n_shards % n_dev:
            raise ValueError(
                f"mesh_config: {n_dev} devices do not divide the {n_shards} shards of layout "
                f"{tuple(cfg.layout)}; choose a layout with 6*ly*lx divisible by the device "
                "count")
        if cfg.pair_debug:
            raise ValueError("pair_debug runs per-stage checkpointers and is a single-device "
                             "debugging tool; disable mesh_config.enabled")
        if cfg.comm_config.type in ("write", "read"):
            raise ValueError(f"comm_config.type {cfg.comm_config.type!r} records or replays one "
                             "process's exchanges; disable mesh_config.enabled")
        _backend, staged, self.device = M.initialize_distributed(self.device)
        if dist.get_world_size() != n_dev:
            raise ValueError(f"mesh_config.n_devices is {n_dev}, and the process group has "
                             f"{dist.get_world_size()} ranks")
        mesh = M.cube_mesh(n_shards, device=self.device, host_staged=staged)
        logger.info("device mesh: %d ranks, %d shards (%d per rank)", n_dev, n_shards, mesh.k)
        return mesh

    @property
    def _writes(self) -> bool:
        """Whether this process writes the run's files (rank 0 of a mesh)."""
        return self.mesh is None or self.mesh.rank == 0

    def _whole(self, obj, names=None):
        """``obj`` (the state, the physics extras) gathered whole to rank 0
        from the ranks' shards (only its fields ``names``, where given), None
        on the other ranks; ``obj`` itself without a mesh."""
        if self.mesh is None or obj is None:
            return obj
        from ..parallel.mesh import gather_state

        return gather_state(obj, self.mesh, names)

    def _diagnostic_names(self):
        """The fields of the state and the physics extras the diagnostics
        read."""
        dc = self.config.diagnostics_config
        names = set(dc.names)
        if dc.derived_names:
            names |= {"q", "delp"}
        for zs in dc.z_select:
            names |= set(zs.names)
        return names

    def _whole_shape(self, t):
        return tuple(t.shape) if self.mesh is None else (self.mesh.n_shards,) + tuple(t.shape[1:])

    def _mesh_ctx(self):
        """The mesh active for the reductions while the model steps."""
        from ..parallel.mesh import shard_mesh

        return shard_mesh(self.mesh) if self.mesh is not None else contextlib.nullcontext()

    def grid_indexing(self, shard: int = 0):
        """The compute-domain geometry of ``shard`` in the model's own
        decomposition (``dsl.GridIndexing``), the window a ``FrozenStencil``
        indexes the driver's padded state arrays by."""
        from ..dsl import GridIndexing

        return GridIndexing.from_halo(self.metric_terms.halo, shard, self.config.nz)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def step_all(self):
        with self._mesh_ctx():
            self._step_all()

    def _step_all(self):
        n = self.config.n_timesteps
        perf = self.config.performance_config
        logger.info("running %d steps of dt=%s s", n, self.config.dt_atmos)
        profiler = perf.build_profiler()
        if profiler is not None:
            profiler.enable()
        trace = self._start_trace() if perf.profile_dir else None
        if self.config.diagnostics_config.output_initial_state:
            self._store_diagnostics()
        for _ in range(n):
            t0 = time.perf_counter()
            if self._pair_cmp is not None:
                # a fresh stage recording for this step's comparison
                self._pair_cmp.begin_step()
            with self.timer.clock("mainloop"):
                self.state = self.dycore.step_dynamics(self.state)
                if self.physics is not None:
                    self.state = self.physics(self.state, self.time_seconds)
            # wait for the device so that each step's time is honest
            self._sync()
            if self.dycore_pair is not None:
                # the replica's comparator raises at the first differing
                # stage and variable; the whole-state check after the step
                # stays as the outer net
                self.state_pair = self.dycore_pair.step_dynamics(self.state_pair)
                self._check_pair()
            self.performance.record_step(time.perf_counter() - t0)
            self.time_seconds += self.config.dt_atmos
            self._step_count += 1
            # the stage profile runs its own profiler: with a whole-run
            # trace open it waits until that trace is written
            if self._step_count == 1 and trace is None:
                self._collect_stage_times()
            self._end_of_step_actions()
        if trace is not None:
            trace.stop()
            logger.info("torch.profiler trace written to %s", perf.profile_dir)
            self._collect_stage_times()
        if profiler is not None:
            profiler.disable()
            if self._writes:
                prof_path = f"{perf.experiment_name}.prof"
                profiler.dump_stats(prof_path)
                logger.info("cProfile written to %s", prof_path)
        if self.config.comm_config.type == "write":
            self.halo.save(self.config.comm_config.path)
            logger.info("halo recording written to %s", self.config.comm_config.path)

    def _start_trace(self):
        """A running torch.profiler over the mainloop, written for
        TensorBoard into ``profile_dir`` when it stops."""
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        trace = profile(activities=activities,
                        on_trace_ready=tensorboard_trace_handler(
                            self.config.performance_config.profile_dir))
        trace.start()
        return trace

    def _collect_stage_times(self):
        """Device seconds of one step per stage (``collect_stage_times``;
        see stage_profile.py), on a copy of the state; the physics stages
        from one physics call."""
        perf = self.config.performance_config
        if not perf.collect_stage_times or self._recorded_exchanges:
            return
        from .stage_profile import STAGES, profile_stage_times

        state = dataclasses.replace(self.state, **{
            f.name: getattr(self.state, f.name).clone()
            for f in dataclasses.fields(self.state)
            if getattr(self.state, f.name) is not None})
        # collect_communication splits the halo exchanges' device time out
        # of their enclosing stage: HaloExchange is the innermost range
        stages = ("HaloExchange",) + STAGES if perf.collect_communication else STAGES
        stage_times = profile_stage_times(self.dycore.step_dynamics, state, stages=stages)
        del state
        if self.physics is not None:
            t = np.float32(self.time_seconds)
            stage_times.update(profile_stage_times(
                self.physics._call_impl, self.state, self.physics.surface_state, t,
                stages=PHYSICS_STAGES,
            ))
        self.performance.stage_device_seconds = stage_times

    def _check_pair(self):
        for name in ("u", "v", "delp", "pt"):
            if not torch.equal(getattr(self.state, name), getattr(self.state_pair, name)):
                raise RuntimeError(
                    f"pair_debug: replica divergence in {name!r} at step {self._step_count}")

    def _store_diagnostics(self):
        names = self._diagnostic_names()
        if not names:
            return
        self.diagnostics.store(self.time_seconds, self._whole(self.state, names),
                               self._whole(self._physics_extras(), names))

    def _save_restart(self, path):
        """The restart files of the whole state (gathered on a mesh), written
        by rank 0."""
        state = self._whole(self.state)
        surface = None
        if self.physics is not None and self.physics.surface_state is not None:
            surface = self._whole(self.physics.surface_state)
        if not self._writes:
            return
        save_restart(path, state, self.time_seconds)
        if surface is not None:
            save_surface_restart(path, surface)
        self.config.write_for_restart(path, self.time_seconds)

    def _end_of_step_actions(self):
        cfg = self.config
        if self._step_count % cfg.diagnostics_config.output_frequency == 0:
            self._store_diagnostics()
            # an ongoing summary at every output step: a crash later on
            # still leaves the timings on disk
            if cfg.performance_config.collect_performance and self._writes:
                self.performance.write_json(
                    f"{cfg.performance_config.experiment_name}_perf.json",
                    cfg.dt_atmos,
                )
        self.safety_checker.check_state(self.state, n_halo=self.metric_terms.spec.n_halo)
        if (
            cfg.restart_config.save_intermediate_restart
            and self._step_count in cfg.restart_config.intermediate_restart
        ):
            self._save_restart(os.path.join(cfg.restart_config.path, f"step_{self._step_count}"))

    def _physics_extras(self):
        """Physics and surface fields for the diagnostics' ``names``
        (precipitation rate, skin temperature, snow, ice, soil state) that
        do not live on the DycoreState; for the mixed surface the inactive
        scheme's fields are NaN."""
        phys = self.physics
        if phys is None or phys.surface_state is None:
            return None
        sfc = phys.surface_state
        extras = {"precipitation": sfc.precip}
        if phys._surface is not None:
            extras.update(phys._surface.diagnostics(sfc))
        return extras

    def _maybe_load_surface(self):
        """Restore the interactive surface's state on a restart (a coupled
        run resumes bit for bit)."""
        init = self.config.initialization
        if init.type not in ("restart", "fortran_restart"):
            return
        if self.physics is None or self.physics._surface is None:
            return
        path = (init.config or {}).get("path", "RESTART")
        if not has_surface_restart(path):
            return
        template = self.physics._surface.init(self._whole_shape(self.state.ps),
                                              self.state.ps.dtype, device=self.device)
        self.physics.surface_state = load_surface_restart(path, template)

    def cleanup(self):
        cfg = self.config
        if cfg.restart_config.save_restart:
            self._save_restart(cfg.restart_config.path)
        self.diagnostics.cleanup()
        if cfg.performance_config.collect_performance and self._writes:
            report = self.performance.report(cfg.dt_atmos)
            logger.info(
                "mainloop mean %.3f s/step, SYPD=%s",
                report["mainloop_mean_seconds"],
                report["SYPD"],
            )
            self.performance.write_json(
                f"{cfg.performance_config.experiment_name}_perf.json",
                cfg.dt_atmos,
            )
