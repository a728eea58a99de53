"""The port stands alone: importing every module of pace_tpu_torch, and
chip_smoke.py, loads neither JAX nor any module of pace_tpu, and neither
PyYAML nor click (the driver reads its configs with its own YAML subset
reader and parses its command line with argparse).

The imports run in a fresh interpreter, because this test session has
imported JAX already and would hide a leak.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import pace_tpu_torch
names = ["pace_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(pace_tpu_torch.__path__, "pace_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaks = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
    or m == "pace_tpu" or m.startswith("pace_tpu.")
    or m.split(".")[0] in ("yaml", "_yaml", "click")
)
print(json.dumps({"modules": names, "leaks": leaks}))
"""


def test_port_imports_no_jax_and_no_pace_tpu():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120, check=True,
    )
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["leaks"] == []
    expected = {
        "pace_tpu_torch.parallel.halo_kernel",
        "pace_tpu_torch.ops.fvtp2d_kernel",
        "pace_tpu_torch.ops.tracer_advection",
        "pace_tpu_torch.grid.grid_data",
        "pace_tpu_torch.demos.tracer_advection",
        "pace_tpu_torch.ops.corners",
        "pace_tpu_torch.ops.d2a2c",
        "pace_tpu_torch.ops.d2a2c_kernel",
        "pace_tpu_torch.ops.c_sw",
        "pace_tpu_torch.ops.c_sw_tail_kernel",
        "pace_tpu_torch.ops.pgrad",
        "pace_tpu_torch.ops.hydro_kernel",
        "pace_tpu_torch.ops.nonhydro",
        "pace_tpu_torch.ops.updatedz_kernel",
        "pace_tpu_torch.ops.sim1_kernel",
        "pace_tpu_torch.models.fv3.init_baroclinic",
        "pace_tpu_torch.models.fv3.state",
        "pace_tpu_torch.models.fv3.acoustics",
        "pace_tpu_torch.demos.cgrid_half_step",
        "pace_tpu_torch.ops.delnflux",
        "pace_tpu_torch.ops.d_sw",
        "pace_tpu_torch.ops.d_sw_tail_kernel",
        "pace_tpu_torch.demos.acoustic_substep",
        "pace_tpu_torch.ops.pgrad_kernel",
        "pace_tpu_torch.ops.remapping",
        "pace_tpu_torch.ops.remap_kernel",
        "pace_tpu_torch.ops.dycore_extras",
        "pace_tpu_torch.ops.moist_cv",
        "pace_tpu_torch.models.fv3.dycore",
        "pace_tpu_torch.demos.dycore_step",
        "pace_tpu_torch.models.shield",
        "pace_tpu_torch.models.shield.microphysics",
        "pace_tpu_torch.models.shield.mf_common",
        "pace_tpu_torch.models.shield.pbl",
        "pace_tpu_torch.models.shield.sas",
        "pace_tpu_torch.models.shield.surface",
        "pace_tpu_torch.models.shield.physics",
        "pace_tpu_torch.demos.physics_step",
        "pace_tpu_torch.utils",
        "pace_tpu_torch.utils.registry",
        "pace_tpu_torch.models.shield.radiation",
        "pace_tpu_torch.models.shield.band_radiation",
        "pace_tpu_torch.models.shield.lsm",
        "pace_tpu_torch.models.shield.seaice",
        "pace_tpu_torch.models.shield.held_suarez",
        "pace_tpu_torch.models.shield.simple_physics",
        "pace_tpu_torch.utils.logging",
        "pace_tpu_torch.utils.filesystem",
        "pace_tpu_torch.utils.native",
        "pace_tpu_torch.utils.netcdf3",
        "pace_tpu_torch.utils.zarr_v2",
        "pace_tpu_torch.utils.yaml_subset",
        "pace_tpu_torch.utils.ranges",
        "pace_tpu_torch.driver",
        "pace_tpu_torch.driver.config",
        "pace_tpu_torch.driver.diagnostics",
        "pace_tpu_torch.driver.driver",
        "pace_tpu_torch.driver.grid",
        "pace_tpu_torch.driver.initialization",
        "pace_tpu_torch.driver.performance",
        "pace_tpu_torch.driver.restart",
        "pace_tpu_torch.driver.run",
        "pace_tpu_torch.driver.safety_checks",
        "pace_tpu_torch.driver.stage_profile",
        "pace_tpu_torch.driver.fortran_restart",
        "pace_tpu_torch.models.fv3.init_tropical_cyclone",
        "pace_tpu_torch.models.fv3.geos_wrapper",
        "pace_tpu_torch.quantity",
        "pace_tpu_torch.utils.namelist",
        "pace_tpu_torch.testing",
        "pace_tpu_torch.testing.checkpointer",
        "pace_tpu_torch.testing.perturb",
        "pace_tpu_torch.testing.sanitizer",
        "pace_tpu_torch.testing.savepoint_cli",
        "pace_tpu_torch.testing.translate",
        "pace_tpu_torch.testing.validation",
        "pace_tpu_torch.parallel.strategies",
        "pace_tpu_torch.parallel.mesh",
        "pace_tpu_torch.parallel.halo_shardmap",
        "pace_tpu_torch.parallel.gather",
        "pace_tpu_torch.dsl",
        "pace_tpu_torch.tools",
        "pace_tpu_torch.tools.zarr_to_nc",
        "pace_tpu_torch.tools.plot_output",
        "pace_tpu_torch.tools.profile_step",
    }
    assert expected <= set(result["modules"])
