"""DycoreState: the prognostic/diagnostic state of the FV3 dynamical core.

Port of ``pace_tpu.models.fv3.state`` (reference role:
``pyFV3.DycoreState``: u, v, w, ua, va, uc, vc, delp, delz, pt, ps, pe,
peln, pk, pkz, phis, omga, q_con, mfxd, mfyd, cxd, cyd, diss_estd + 9
tracers).

One flat dataclass of stacked torch tensors (S, [K,] Y, X) on one device;
tracers are one stacked block (S, nq, K, Y, X) indexed by TRACER_NAMES, so
the transport operators run over the whole block at once.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ... import constants
from ...constants import TRACER_NAMES
from ...dtypes import check_dtype, resolve_device, to_tensor


@dataclasses.dataclass
class DycoreState:
    # prognostic
    u: torch.Tensor  # (S, K, Y+1, X) D-grid covariant x-wind [m/s]
    v: torch.Tensor  # (S, K, Y, X+1)
    delp: torch.Tensor  # (S, K, Y, X) pressure thickness [Pa]
    pt: torch.Tensor  # (S, K, Y, X) virtual potential temperature [K]
    q: torch.Tensor  # (S, nq, K, Y, X) tracers [kg/kg]
    w: Optional[torch.Tensor] = None  # (S, K, Y, X) vertical velocity [m/s]
    delz: Optional[torch.Tensor] = None  # (S, K, Y, X) layer height [m], negative

    # surface / column diagnostics
    phis: Optional[torch.Tensor] = None  # (S, Y, X) surface geopotential
    ps: Optional[torch.Tensor] = None  # (S, Y, X) surface pressure
    pe: Optional[torch.Tensor] = None  # (S, K+1, Y, X) interface pressure
    peln: Optional[torch.Tensor] = None
    pk: Optional[torch.Tensor] = None  # (pe/P_REF)^kappa at interfaces
    pkz: Optional[torch.Tensor] = None  # layer-mean pk
    omga: Optional[torch.Tensor] = None  # dp/dt [Pa/s]

    # A/C-grid wind diagnostics (filled by the dycore step)
    ua: Optional[torch.Tensor] = None
    va: Optional[torch.Tensor] = None
    uc: Optional[torch.Tensor] = None
    vc: Optional[torch.Tensor] = None

    # accumulated fluxes (for physics/diagnostics)
    mfxd: Optional[torch.Tensor] = None
    mfyd: Optional[torch.Tensor] = None
    cxd: Optional[torch.Tensor] = None
    cyd: Optional[torch.Tensor] = None
    diss_estd: Optional[torch.Tensor] = None
    q_con: Optional[torch.Tensor] = None

    @property
    def qvapor(self):
        return self.q[:, TRACER_NAMES.index("qvapor")]

    def tracer(self, name: str):
        return self.q[:, TRACER_NAMES.index(name)]

    @classmethod
    def init_zeros(cls, shapes, device="cuda", dtype=torch.float32) -> "DycoreState":
        """Allocate an all-zero state. ``shapes`` is a dict with S, K, Y, X."""
        dev = resolve_device(device)
        check_dtype(dtype)
        S, K, Y, X = shapes["S"], shapes["K"], shapes["Y"], shapes["X"]
        z = lambda *sh: torch.zeros(sh, dtype=dtype, device=dev)  # noqa: E731
        return cls(
            u=z(S, K, Y + 1, X),
            v=z(S, K, Y, X + 1),
            delp=z(S, K, Y, X),
            pt=z(S, K, Y, X),
            q=z(S, len(TRACER_NAMES), K, Y, X),
            w=z(S, K, Y, X),
            delz=z(S, K, Y, X),
            phis=z(S, Y, X),
            ps=z(S, Y, X),
            pe=z(S, K + 1, Y, X),
            peln=z(S, K + 1, Y, X),
            pk=z(S, K + 1, Y, X),
            pkz=z(S, K, Y, X),
        )

    @classmethod
    def from_numpy(cls, arrays: dict, device="cuda", dtype=torch.float32) -> "DycoreState":
        """The state from its fields as numpy arrays keyed by field name
        (e.g. ``{f: np.asarray(getattr(st, f))}`` of a ``pace_tpu``
        ``DycoreState``); fields that are absent or ``None`` stay ``None``."""
        dev = resolve_device(device)
        check_dtype(dtype)
        kw = {}
        for f in dataclasses.fields(cls):
            a = arrays.get(f.name)
            if a is not None:
                kw[f.name] = to_tensor(a, dev, dtype)
        return cls(**kw)

    def to_numpy(self) -> dict:
        """Every populated field as a numpy array, keyed by field name."""
        return {
            f.name: getattr(self, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(self)
            if getattr(self, f.name) is not None
        }

    @classmethod
    def from_analytic_init(cls, mt, case: str = "baroclinic", perturbation: bool = True,
                           device="cuda", dtype=torch.float32) -> "DycoreState":
        """Build from an analytic test case (reference role:
        ``pyFV3.initialization.analytic_init.init_analytic_state``): cases
        ``"baroclinic"`` and ``"tropicalcyclone"``, the moist Reed-Jablonowski
        vortex, which fills ``qvapor`` (``perturbation`` does not apply)."""
        if case == "baroclinic":
            return cls.from_baroclinic_init(mt, perturbation=perturbation, device=device,
                                            dtype=dtype)
        if case == "tropicalcyclone":
            from .init_tropical_cyclone import init_tropical_cyclone_state

            return cls._from_init_dict(mt, init_tropical_cyclone_state(mt), device, dtype)
        raise ValueError(f"unknown analytic init case {case!r}")

    @classmethod
    def from_baroclinic_init(cls, mt, perturbation: bool = True, moist: bool = False,
                             device="cuda", dtype=torch.float32) -> "DycoreState":
        """Build from the JW06 analytic state (see init_baroclinic).
        ``moist`` is taken and ignored, as ``pace_tpu``'s is: the state is dry,
        every tracer zero (ROADMAP queue 3)."""
        from .init_baroclinic import init_baroclinic_state

        st = init_baroclinic_state(mt, perturbation=perturbation)
        return cls._from_init_dict(mt, st, device, dtype)

    @classmethod
    def _from_init_dict(cls, mt, st, device, dtype) -> "DycoreState":
        """Assemble a full DycoreState from an analytic-init dict with keys
        u, v, delp, pt, phis, ps (+ optional qvapor)."""
        S, K = st["delp"].shape[:2]
        Y, X = st["delp"].shape[2:]
        q = np.zeros((S, len(TRACER_NAMES), K, Y, X))
        if "qvapor" in st:
            q[:, TRACER_NAMES.index("qvapor")] = st["qvapor"]
        pe = mt.ak[None, :, None, None] + mt.bk[None, :, None, None] * st["ps"][:, None]
        peln = np.log(np.maximum(pe, 1e-8))
        pk = (pe / constants.P_REF) ** constants.KAPPA
        pkz = (pk[:, 1:] - pk[:, :-1]) / (
            constants.KAPPA * (peln[:, 1:] - peln[:, :-1])
        )
        # nonhydrostatic fields: hydrostatically-balanced layer depths, w=0
        t_v = st["pt"] * pkz
        delz = (
            -constants.RDGAS / constants.GRAV * t_v * (peln[:, 1:] - peln[:, :-1])
        )
        zc = np.zeros_like(st["delp"])
        zu = np.zeros_like(st["u"])
        zv = np.zeros_like(st["v"])
        return cls.from_numpy(
            dict(
                u=st["u"], v=st["v"], delp=st["delp"], pt=st["pt"], q=q, w=zc,
                delz=delz, phis=st["phis"], ps=st["ps"], pe=pe, peln=peln, pk=pk,
                pkz=pkz, ua=zc, va=zc, uc=zv, vc=zu, mfxd=zv, mfyd=zu, cxd=zv,
                cyd=zu, diss_estd=zc, omga=zc,
            ),
            device=device, dtype=dtype,
        )


# dims (beyond the leading shard axis S) and units for each field, for the
# dataset export below
FIELD_METADATA = {
    "u": (("z", "y_interface", "x"), "m/s"),
    "v": (("z", "y", "x_interface"), "m/s"),
    "delp": (("z", "y", "x"), "Pa"),
    "pt": (("z", "y", "x"), "degK"),
    "w": (("z", "y", "x"), "m/s"),
    "delz": (("z", "y", "x"), "m"),
    "phis": (("y", "x"), "m^2 s^-2"),
    "ps": (("y", "x"), "Pa"),
    "pe": (("z_interface", "y", "x"), "Pa"),
    "peln": (("z_interface", "y", "x"), "ln(Pa)"),
    "pk": (("z_interface", "y", "x"), "(Pa)**kappa"),
    "pkz": (("z", "y", "x"), "(Pa)**kappa"),
    "omga": (("z", "y", "x"), "Pa/s"),
    "ua": (("z", "y", "x"), "m/s"),
    "va": (("z", "y", "x"), "m/s"),
    "uc": (("z", "y", "x_interface"), "m/s"),
    "vc": (("z", "y_interface", "x"), "m/s"),
    "mfxd": (("z", "y", "x_interface"), "Pa m^2"),
    "mfyd": (("z", "y_interface", "x"), "Pa m^2"),
    "cxd": (("z", "y", "x_interface"), ""),
    "cyd": (("z", "y_interface", "x"), ""),
    "diss_estd": (("z", "y", "x"), ""),
    "q_con": (("z", "y", "x"), "kg/kg"),
}


def _dataset_items(state: DycoreState):
    for name, (dims, units) in FIELD_METADATA.items():
        t = getattr(state, name)
        if t is not None:
            yield name, ("shard",) + dims, units, t.detach().cpu().numpy()
    q = getattr(state, "q", None)
    if q is not None:
        for i, tname in enumerate(TRACER_NAMES):
            yield tname, ("shard", "z", "y", "x"), "kg/kg", q[:, i].detach().cpu().numpy()


def as_dataset(state: DycoreState):
    """Name -> {dims, units, data} (numpy on the host) for every populated
    field, tracers unstacked by name: ``pace_tpu``'s ``as_dataset`` (reference
    role: ``DycoreState.xr_dataset``) without an xarray dependency."""
    return {
        name: {"dims": dims, "units": units, "data": arr}
        for name, dims, units, arr in _dataset_items(state)
    }


def to_netcdf(state: DycoreState, path: str) -> None:
    """Write every populated field to one classic NetCDF-3 file with shared
    named dimensions, as ``pace_tpu``'s ``to_netcdf`` does."""
    from ...utils import netcdf3

    dims: dict = {}
    variables: dict = {}
    for name, dnames, units, arr in _dataset_items(state):
        full = []
        for d, sz in zip(dnames, arr.shape):
            # interface dims differ in length from their center dims
            key = d
            if key in dims and dims[key] != int(sz):
                key = f"{d}{sz}"
            dims.setdefault(key, int(sz))
            full.append(key)
        variables[name] = netcdf3.Variable(
            dims=tuple(full), data=arr, attrs={"units": units}
        )
    netcdf3.write(path, netcdf3.NetCDF3File(dims=dims, variables=variables, attrs={}))
