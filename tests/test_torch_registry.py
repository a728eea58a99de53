"""The port's configuration loader against pace_tpu's.

``from_dict`` of ``pace_tpu_torch.utils.registry`` builds the same configs
as ``pace_tpu.utils.registry.from_dict`` from the same mappings (each
physics config of both packages, from the example configs' physics
sections, and nested, optional, list and tuple fields), and raises
``ConfigError`` with the same messages for unknown keys, wrong types and
non-mappings, ``TypeError`` for a class that is no dataclass.
"""

import dataclasses
from typing import List, Optional, Tuple

import pytest

from pace_tpu.models.shield import band_radiation as jband
from pace_tpu.models.shield import held_suarez as jhs
from pace_tpu.models.shield import lsm as jlsm
from pace_tpu.models.shield import pbl as jpbl
from pace_tpu.models.shield import radiation as jrad
from pace_tpu.models.shield import seaice as jice
from pace_tpu.models.shield import surface as jsurf
from pace_tpu.utils import registry as jreg
from pace_tpu_torch.models.shield import band_radiation as tband
from pace_tpu_torch.models.shield import held_suarez as ths
from pace_tpu_torch.models.shield import lsm as tlsm
from pace_tpu_torch.models.shield import pbl as tpbl
from pace_tpu_torch.models.shield import radiation as trad
from pace_tpu_torch.models.shield import seaice as tice
from pace_tpu_torch.models.shield import surface as tsurf
from pace_tpu_torch.utils import registry as treg

#: (port class, pace_tpu class, mapping): the physics sections of the
#: example configs and overrides of every kind of field
LOADS = [
    (tsurf.SurfaceConfig, jsurf.SurfaceConfig,
     {"type": "mixed", "land_lat_max": 55, "t_init": 288.0, "smc_init": 0.25}),
    (tsurf.SurfaceConfig, jsurf.SurfaceConfig,
     {"type": "seaice", "t_init": 285.0, "h_ice_init": 0,
      "seaice": {"slab_ocean": True, "mixed_layer_depth": 30.0}}),
    (trad.GrayRadiationConfig, jrad.GrayRadiationConfig, {"interactive_vapor": True}),
    (trad.GrayRadiationConfig, jrad.GrayRadiationConfig,
     {"t_surf": 295, "diurnal": True, "seasonal": True}),
    (tpbl.PBLConfig, jpbl.PBLConfig, {"sensible_heat_flux": 0.01, "latent_heat_flux": 4e-5}),
    (tband.BandRadiationConfig, jband.BandRadiationConfig,
     {"co2_ppmv": 800, "k_h2o": [4.0, 1.0, 0.02, 1.5, 0.2]}),
    (ths.HeldSuarezConfig, jhs.HeldSuarezConfig, {"delta_t_y": 40}),
    (tlsm.LSMConfig, jlsm.LSMConfig, {"z0": 0.05, "newton_iters": 4.0}),
    (tice.SeaIceConfig, jice.SeaIceConfig, {"h_min": 0.02, "newton_iters": 2}),
    (tsurf.SurfaceConfig, jsurf.SurfaceConfig, None),
]


@dataclasses.dataclass
class Inner:
    a: float = 1.0
    b: int = 2


@dataclasses.dataclass
class Outer:
    inner: Inner = dataclasses.field(default_factory=Inner)
    maybe: Optional[Inner] = None
    many: List[Inner] = dataclasses.field(default_factory=list)
    pair: Tuple[float, ...] = (0.0, 0.0)
    name: str = "x"
    flag: bool = False
    anything: object = None


NESTED = {"inner": {"a": 3, "b": 4.0}, "maybe": {"a": 0.5}, "many": [{"b": 1}, {"a": 2}],
          "pair": [1, 2.5], "name": "y", "flag": True, "anything": [1, "two"]}


@pytest.mark.parametrize("tcls,jcls,data", LOADS, ids=lambda x: getattr(x, "__name__", None))
def test_from_dict_builds_pace_tpu_s_configs(tcls, jcls, data):
    got, want = treg.from_dict(tcls, data), jreg.from_dict(jcls, data)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [type(getattr(got, f.name)) for f in dataclasses.fields(got)] == \
        [type(getattr(want, f.name)) for f in dataclasses.fields(want)]


def test_from_dict_nested_fields():
    got, want = treg.from_dict(Outer, NESTED), jreg.from_dict(Outer, NESTED)
    assert got == want
    assert got.inner == Inner(a=3.0, b=4) and isinstance(got.inner.a, float)
    assert got.pair == (1, 2.5) and isinstance(got.pair, tuple)
    assert treg.from_dict(Outer, {"inner": Inner(a=9.0)}).inner == Inner(a=9.0)


@pytest.mark.parametrize("cls,data", [
    (Outer, {"innr": {}}),
    (Outer, {"inner": 3}),
    (Outer, {"name": 3}),
    (Outer, {"flag": "yes"}),
    (Inner, {"b": 2.5}),
    (tlsm.LSMConfig, {"albedo": "high"}),
], ids=["unknown key", "not a mapping", "str", "bool", "int", "float"])
def test_from_dict_errors_are_pace_tpu_s(cls, data):
    jcls = getattr(jlsm, cls.__name__, cls)
    with pytest.raises(jreg.ConfigError) as want:
        jreg.from_dict(jcls, data)
    with pytest.raises(treg.ConfigError) as got:
        treg.from_dict(cls, data)
    assert str(got.value) == str(want.value)
    assert issubclass(treg.ConfigError, ValueError)


def test_from_dict_refuses_a_non_dataclass():
    with pytest.raises(TypeError):
        treg.from_dict(dict, {})
