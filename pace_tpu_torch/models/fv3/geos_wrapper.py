"""Raw-array dycore wrapper for external host models.

Port of ``pace_tpu.models.fv3.geos_wrapper`` (reference role:
``pyFV3.GeosDycoreWrapper``: constructed from a namelist + timestep, called
with raw numpy arrays u, v, w, delz, pt, delp, q, ps, pe, pk, peln, pkz,
phis, q_con, omga, ua, va, uc, vc, mfx, mfy, cx, cy, diss_est; returns a
dict of updated arrays). The caller owns the memory layout; this wrapper
moves the arrays to its device as a DycoreState, steps it, and hands back
plain numpy arrays under the same names — a second entry point into the
dycore, for host models.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from ...constants import TRACER_NAMES
from ...dtypes import check_dtype, resolve_device, to_tensor
from ...grid.generation import GridSpec, MetricTerms
from ...grid.grid_data import GridData
from ...utils.namelist import Namelist
from .dycore import DynamicalCore, DynamicalCoreConfig
from .state import DycoreState


class GeosDycoreWrapper:
    """Drive the dycore from raw stacked-tile numpy arrays.

    Parameters
    ----------
    namelist:
        a :class:`Namelist`, a path to an input.nml, or a
        :class:`DynamicalCoreConfig`.
    n_tile, npz:
        horizontal tile size and level count (the reference derives these
        from the namelist npx/npy/npz).
    bdt:
        timestep seconds (reference ``bdt``).
    device, dtype:
        where the dycore runs (the card unless ``"cpu"``) and its precision.
    """

    def __init__(
        self,
        namelist: Union[Namelist, str, DynamicalCoreConfig],
        n_tile: int,
        npz: int,
        bdt: float,
        layout=(1, 1),
        device="cuda",
        dtype=torch.float32,
    ):
        if isinstance(namelist, DynamicalCoreConfig):
            config = namelist
        else:
            if not isinstance(namelist, Namelist):
                namelist = Namelist.from_f90nml(namelist)
            config = namelist.dycore_config()
        config = dataclasses.replace(config, npz=npz)
        self.config = config
        self.device = resolve_device(device)
        self._dtype = check_dtype(dtype)
        spec = GridSpec(n_tile=n_tile, npz=npz, layout=tuple(layout))
        self.metric_terms = MetricTerms.generate(spec)
        self.grid = GridData.from_metric_terms(self.metric_terms, device=self.device,
                                               dtype=dtype)
        self.dycore = DynamicalCore(
            self.grid, self.metric_terms.halo, config, timestep=float(bdt)
        )

    @property
    def tracer_names(self):
        return TRACER_NAMES

    def __call__(
        self,
        u: np.ndarray,
        v: np.ndarray,
        w: np.ndarray,
        delz: np.ndarray,
        pt: np.ndarray,
        delp: np.ndarray,
        q: np.ndarray,
        ps: np.ndarray,
        pe: np.ndarray,
        pk: np.ndarray,
        peln: np.ndarray,
        pkz: np.ndarray,
        phis: np.ndarray,
        q_con: Optional[np.ndarray] = None,
        omga: Optional[np.ndarray] = None,
        ua: Optional[np.ndarray] = None,
        va: Optional[np.ndarray] = None,
        uc: Optional[np.ndarray] = None,
        vc: Optional[np.ndarray] = None,
        mfxd: Optional[np.ndarray] = None,
        mfyd: Optional[np.ndarray] = None,
        cxd: Optional[np.ndarray] = None,
        cyd: Optional[np.ndarray] = None,
        diss_estd: Optional[np.ndarray] = None,
    ) -> Dict[str, np.ndarray]:
        """One dycore step over raw arrays; returns the updated fields."""
        j = lambda a: to_tensor(a, self.device, self._dtype)  # noqa: E731
        nq = len(TRACER_NAMES)
        q = np.asarray(q)
        if q.shape[1] < nq:  # the reference GEOS path passes 7 tracers
            padded = np.zeros((q.shape[0], nq) + q.shape[2:], dtype=q.dtype)
            padded[:, : q.shape[1]] = q
            q = padded

        def opt(a, like):
            return j(a) if a is not None else j(np.zeros_like(np.asarray(like)))

        state = DycoreState(
            u=j(u),
            v=j(v),
            delp=j(delp),
            pt=j(pt),
            q=j(q),
            w=j(w),
            delz=j(delz),
            phis=j(phis),
            ps=j(ps),
            pe=j(pe),
            peln=j(peln),
            pk=j(pk),
            pkz=j(pkz),
            ua=opt(ua, delp),
            va=opt(va, delp),
            uc=opt(uc, v),
            vc=opt(vc, u),
            mfxd=opt(mfxd, v),
            mfyd=opt(mfyd, u),
            cxd=opt(cxd, v),
            cyd=opt(cyd, u),
            diss_estd=opt(diss_estd, delp),
            q_con=j(q_con) if q_con is not None else None,
            omga=j(omga) if omga is not None else None,
        )
        out = self.dycore.step_dynamics(state)
        names = (
            "u", "v", "w", "delz", "pt", "delp", "q", "ps", "pe", "pk",
            "peln", "pkz", "phis", "ua", "va", "uc", "vc", "mfxd", "mfyd",
            "cxd", "cyd", "diss_estd",
        )
        return {
            nm: getattr(out, nm).detach().cpu().numpy()
            for nm in names
            if getattr(out, nm) is not None
        }
