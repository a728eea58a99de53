"""The reference model: the frozen plain copy (``fv3ref``) built from a run's
driver configuration, as the program's ``Driver`` builds itself.

It reads the same configuration dict as the program (the yaml as run, with
the cell's overrides) and derives its own grid, initial state, dynamical
core and physics from it. Nothing here imports the program.

With a ``mesh`` (``fv3ref/parallel/mesh.py``: one rank's block of the
shards over the running process group) the model holds that block, as the
program's ``Driver`` does with ``mesh_config.enabled``: the grid cut to the
block, the exchange across ranks (``fv3ref/parallel/halo_gather.py``: the
one-process exchange on the gathered cube), the whole-cube reductions over
the ranks while it steps.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace
from typing import Dict, Optional, Sequence

import torch

from .fv3ref.driver.grid import GridConfig
from .fv3ref.grid.grid_data import GridData
from .fv3ref.models.fv3.dycore import DynamicalCore, DynamicalCoreConfig
from .fv3ref.models.fv3.state import DycoreState
from .fv3ref.parallel.mesh import CubeMesh, shard_mesh
from .fv3ref.utils.registry import from_dict

#: the physics configs' keys that live in dycore_config (the program's
#: driver shares them with the dycore's saturation adjustment)
_SHARED_MICROPHYSICS = ("tau_l2v", "tau_v2l", "tau_i2s", "tau_g2v", "ql_gen", "ql_mlt", "qs_mlt",
                        "qi_lim", "dw_ocean", "dw_land", "icloud_f", "do_qa")


@dataclasses.dataclass
class ReferenceModel:
    metric_terms: object
    grid: GridData
    dycore: DynamicalCore
    physics: Optional[object]
    dt_atmos: float
    mesh: Optional[CubeMesh] = None

    def step(self, state: DycoreState, time_seconds: float) -> DycoreState:
        """One step as the driver's mainloop takes it: the dycore, then the
        physics at the step's model time (on a mesh, with the mesh active
        for the reductions)."""
        with shard_mesh(self.mesh):
            state = self.dycore.step_dynamics(state)
            if self.physics is not None:
                state = self.physics(state, time_seconds)
        return state


def dycore_config(raw: dict) -> DynamicalCoreConfig:
    dyc = dict(raw.get("dycore_config") or {})
    dyc["npz"] = raw.get("nz", 79)
    return from_dict(DynamicalCoreConfig, dyc)


def metric_terms(raw: dict):
    grid_cfg = from_dict(GridConfig, raw.get("grid_config") or {})
    return grid_cfg.get_metric_terms(raw["nx_tile"], raw.get("nz", 79),
                                     tuple(raw.get("layout", (1, 1))))


#: the metric terms the analytic initial states read, all shard-leading but
#: the hybrid coefficients
_INIT_TERMS = ("lat_agrid", "lon_agrid", "xyz_u", "xyz_v", "es1", "ew2")


def _shard_terms(mt, s: int) -> SimpleNamespace:
    return SimpleNamespace(ak=mt.ak, bk=mt.bk,
                           **{k: getattr(mt, k)[s:s + 1] for k in _INIT_TERMS})


def initial_state(raw: dict, mt, device, dtype,
                  shards: Optional[Sequence[int]] = None) -> DycoreState:
    """The analytic initial state the configuration names (``baroclinic``,
    ``tropicalcyclone``, or ``analytic`` with its ``case``), before the
    benchmark's seeded inputs. Both states are pointwise in the shards, so
    each shard is built on its own thread (the program builds the whole
    cube in one call); the fields are then stacked. ``shards``: only those
    shards, in order (a rank's block; all by default)."""
    from .fv3ref.models.fv3.init_baroclinic import init_baroclinic_state
    from .fv3ref.models.fv3.init_tropical_cyclone import init_tropical_cyclone_state

    init = raw.get("initialization") or {}
    kind = init.get("type", "baroclinic")
    cfg = init.get("config") or {}
    if kind not in ("baroclinic", "analytic", "tropicalcyclone"):
        raise ValueError(f"the reference builds analytic initial states only, not {kind!r}")
    case = cfg.get("case", "baroclinic") if kind == "analytic" else kind
    perturbation = bool(cfg.get("perturbation", True))

    def shard(s):
        view = _shard_terms(mt, s)
        st = (init_baroclinic_state(view, perturbation=perturbation) if case == "baroclinic"
              else init_tropical_cyclone_state(view))
        return DycoreState._from_init_dict(view, st, "cpu", dtype)

    shards = list(range(mt.lon_agrid.shape[0]) if shards is None else shards)
    with ThreadPoolExecutor(max_workers=min(len(shards), os.cpu_count() or 1)) as pool:
        parts = list(pool.map(shard, shards))
    fields = {}
    for f in dataclasses.fields(DycoreState):
        vals = [getattr(p, f.name) for p in parts]
        if all(isinstance(v, torch.Tensor) for v in vals):
            fields[f.name] = torch.cat(vals).to(device)
    return DycoreState(**fields)


def build_physics(raw: dict, grid, halo, dyc: DynamicalCoreConfig, dt_atmos: float):
    """The physics the program's driver builds from the same dict, or None."""
    from .fv3ref.models.shield.band_radiation import BandRadiationConfig
    from .fv3ref.models.shield.held_suarez import HeldSuarezConfig
    from .fv3ref.models.shield.microphysics import MicrophysicsConfig
    from .fv3ref.models.shield.pbl import PBLConfig
    from .fv3ref.models.shield.physics import Physics
    from .fv3ref.models.shield.radiation import GrayRadiationConfig
    from .fv3ref.models.shield.sas import DeepConvectionConfig, ShallowConvectionConfig
    from .fv3ref.models.shield.surface import SurfaceConfig

    pc = raw.get("physics_config") or {}
    schemes = tuple(pc.get("schemes") or ())
    run_physics = bool(schemes) and not raw.get("dycore_only") and not raw.get(
        "disable_step_physics")
    if not run_physics and not dyc.fv_sg_adj > 0:
        return None
    shared = {k: getattr(dyc, k) for k in _SHARED_MICROPHYSICS}
    return Physics(
        grid, schemes if run_physics else (), dt_atmos, fv_sg_adj=dyc.fv_sg_adj,
        config=from_dict(MicrophysicsConfig, {**shared, **(pc.get("microphysics") or {})}),
        pbl_config=from_dict(PBLConfig, pc.get("pbl") or {}),
        radiation_config=from_dict(GrayRadiationConfig, pc.get("radiation") or {}),
        sas_config=from_dict(ShallowConvectionConfig, pc.get("shallow_convection") or {}),
        deep_config=from_dict(DeepConvectionConfig, pc.get("deep_convection") or {}),
        surface_config=from_dict(SurfaceConfig, pc.get("surface") or {}),
        held_suarez_config=from_dict(HeldSuarezConfig, pc.get("held_suarez") or {}),
        band_radiation_config=from_dict(BandRadiationConfig, pc.get("band_radiation") or {}),
        halo=halo,
    )


def build(raw: dict, device, dtype=torch.float32, mt=None,
          mesh: Optional[CubeMesh] = None) -> ReferenceModel:
    """The reference model of the driver configuration ``raw`` on
    ``device`` in ``dtype``; ``mt``: metric terms already derived by
    :func:`metric_terms` from the same dict; ``mesh``: this rank's block of
    the shards (None: the whole cube)."""
    mt = mt if mt is not None else metric_terms(raw)
    grid = GridData.from_metric_terms(mt, device=device, dtype=dtype)
    halo = mt.halo
    if mesh is not None:
        from .fv3ref.parallel.halo_gather import GatherHalo

        grid = grid.shard_block(mesh.lo, mesh.hi, mesh.n_shards)
        halo = GatherHalo(mt.halo.slabs, mesh)
    dyc = dycore_config(raw)
    dt = float(raw.get("dt_atmos", 225.0))
    core = DynamicalCore(grid, halo, dyc, dt)
    return ReferenceModel(mt, grid, core, build_physics(raw, grid, halo, dyc, dt), dt, mesh)


def state_from_tensors(fields: Dict[str, torch.Tensor], device, dtype) -> DycoreState:
    """A reference ``DycoreState`` holding ``fields`` (the program's state
    by field name, on any device) on ``device`` in ``dtype``."""
    names = {f.name for f in dataclasses.fields(DycoreState)}
    return DycoreState(**{k: v.to(device=device, dtype=dtype) for k, v in fields.items()
                          if k in names and v is not None})


def fill_dataclass(template, fields: Dict[str, torch.Tensor], device, dtype, prefix=""):
    """``template`` (a nested dataclass of tensors) with every tensor leaf
    replaced by ``fields[<dotted name>]`` on ``device`` in ``dtype``."""
    out = {}
    for f in dataclasses.fields(template):
        v = getattr(template, f.name)
        name = prefix + f.name
        if dataclasses.is_dataclass(v):
            out[f.name] = fill_dataclass(v, fields, device, dtype, name + ".")
        elif isinstance(v, torch.Tensor):
            out[f.name] = fields[name].to(device=device, dtype=dtype)
        else:
            out[f.name] = v
    return dataclasses.replace(template, **out)

