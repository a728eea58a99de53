"""The stencil layer's surface: ``GridIndexing``, ``FrozenStencil`` and
``StencilFactory``.

Port of ``pace_tpu.dsl`` (reference role: ``ndsl.dsl``'s
``StencilFactory.from_origin_domain(func, origin, domain) -> FrozenStencil``,
``GridIndexing``, ``StencilConfig``, ``CompilationConfig`` and ``RunMode``).
There is no stencil compiler: a stencil is any function of tensor windows.
What the layer keeps is what users program against:

- ``GridIndexing``: a shard's compute domain and halo inside the padded
  arrays, with its tile-edge flags and origin/domain helpers.
- ``FrozenStencil``: a function bound to a fixed (origin, domain) window of
  the trailing axes; a call cuts the window out of each input, applies the
  function and writes the results into copies of the outputs (where the
  window is the whole array, the results are the outputs).
- ``StencilConfig`` / ``CompilationConfig`` / ``RunMode``: kept for the
  configs; ``validate_args`` checks shapes and dtypes on every call,
  ``compare_to_numpy`` runs the function again on host copies of the
  windows and holds the two results together, ``run_mode = Build`` checks
  the call and runs nothing, ``device_sync`` waits for the card.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from . import constants


class RunMode(enum.Enum):
    """``Build``: check the call and run nothing; ``BuildAndRun`` and
    ``Run``: run (nothing is compiled ahead)."""

    Build = 0
    BuildAndRun = 1
    Run = 2


@dataclasses.dataclass(frozen=True)
class CompilationConfig:
    """``backend`` is kept for the configs; the port has one."""

    backend: str = "xla"
    rebuild: bool = False
    validate_args: bool = True
    format_source: bool = False
    device_sync: bool = False
    run_mode: RunMode = RunMode.BuildAndRun
    use_minimal_caching: bool = False


@dataclasses.dataclass(frozen=True)
class StencilConfig:
    compilation_config: CompilationConfig = CompilationConfig()
    compare_to_numpy: bool = False


@dataclasses.dataclass(frozen=True)
class GridIndexing:
    """A shard's compute-domain geometry: ``domain`` is its (nz, ny, nx)
    compute extent, ``n_halo`` the ghost width, and the edge flags say
    whether it touches its tile's boundary (all four at layout (1, 1))."""

    domain: Tuple[int, int, int]
    n_halo: int = constants.N_HALO_DEFAULT
    south_edge: bool = True
    north_edge: bool = True
    west_edge: bool = True
    east_edge: bool = True

    @classmethod
    def from_sizer(cls, sizer, shard_y: int = 0, shard_x: int = 0,
                   layout: Tuple[int, int] = (1, 1)) -> "GridIndexing":
        """From a ``SubtileGridSizer`` and the shard's place in the layout."""
        return cls(
            domain=(sizer.nz, sizer.ny, sizer.nx),
            n_halo=sizer.n_halo,
            south_edge=shard_y == 0,
            north_edge=shard_y == layout[0] - 1,
            west_edge=shard_x == 0,
            east_edge=shard_x == layout[1] - 1,
        )

    @classmethod
    def from_halo(cls, halo, shard: int, nz: int) -> "GridIndexing":
        """From the model's own decomposition (a ``HaloExchanger``): the
        window of the padded arrays the model allocates
        (``Driver.grid_indexing``)."""
        _tile, py, px = halo._shard_info(shard)
        ly, lx = halo.partitioner.layout
        return cls(
            domain=(nz, halo.nsy, halo.nsx),
            n_halo=halo.n_halo,
            south_edge=py == 0,
            north_edge=py == ly - 1,
            west_edge=px == 0,
            east_edge=px == lx - 1,
        )

    @property
    def origin_compute(self) -> Tuple[int, int, int]:
        return (0, self.n_halo, self.n_halo)

    @property
    def domain_compute(self) -> Tuple[int, int, int]:
        return self.domain

    def origin_full(self) -> Tuple[int, int, int]:
        return (0, 0, 0)

    def domain_full(self, add: Tuple[int, int, int] = (0, 0, 0)):
        nz, ny, nx = self.domain
        return (nz + add[0], ny + 2 * self.n_halo + add[1], nx + 2 * self.n_halo + add[2])

    def get_origin_domain(self, dims: Sequence[str], halos: Tuple[int, int] = (0, 0)):
        """(origin, domain) of fields named by ``dims``, with ``halos`` extra
        rows and columns in the window; other axes (shards, tracers) whole
        (domain -1)."""
        nz, ny, nx = self.domain
        origin = []
        domain = []
        for d in dims:
            if d.startswith("z"):
                origin.append(0)
                domain.append(nz + (1 if "interface" in d else 0))
            elif d.startswith("y"):
                origin.append(self.n_halo - halos[0])
                domain.append(ny + 2 * halos[0] + (1 if "interface" in d else 0))
            elif d.startswith("x"):
                origin.append(self.n_halo - halos[1])
                domain.append(nx + 2 * halos[1] + (1 if "interface" in d else 0))
            else:
                origin.append(0)
                domain.append(-1)
        return tuple(origin), tuple(domain)


class FrozenStencil:
    """A function bound to a fixed (origin, domain) window.

    ``func(*windows) -> window | tuple`` sees the windows only: a call cuts
    each input at (origin, domain) on its trailing ``len(origin)`` axes
    (domain -1: to the end), applies ``func`` and writes the results back
    into copies of the first ``n_outputs`` inputs.
    """

    def __init__(self, func: Callable, origin: Tuple[int, ...], domain: Tuple[int, ...],
                 n_outputs: int = 1, config: Optional[StencilConfig] = None):
        self.func = func
        self.origin = tuple(int(o) for o in origin)
        self.domain = tuple(int(d) for d in domain)
        self.n_outputs = n_outputs
        self.config = config or StencilConfig()
        self._shapes: Optional[Tuple] = None
        #: the window is each output whole: the results are the outputs
        self._whole = all(o == 0 for o in self.origin) and all(d == -1 for d in self.domain)

    def _window(self, arr):
        nd = len(self.origin)
        sl = [slice(None)] * (arr.ndim - nd)
        for o, d in zip(self.origin, self.domain):
            sl.append(slice(o, None) if d == -1 else slice(o, o + d))
        return tuple(sl)

    def _call_impl(self, *args):
        res = self.func(*[a[self._window(a)] for a in args])
        if not isinstance(res, tuple):
            res = (res,)
        outs = []
        for i in range(self.n_outputs):
            if self._whole and res[i].shape == args[i].shape:
                outs.append(res[i])
                continue
            out = args[i].clone()
            out[self._window(out)] = res[i]
            outs.append(out)
        return outs[0] if self.n_outputs == 1 else tuple(outs)

    def __call__(self, *args):
        cc = self.config.compilation_config
        if cc.validate_args:
            shapes = tuple((tuple(a.shape), str(a.dtype)) for a in args)
            if self._shapes is None:
                self._shapes = shapes
            elif shapes != self._shapes:
                raise TypeError(
                    f"FrozenStencil called with {shapes}, built for {self._shapes}"
                )
        if cc.run_mode is RunMode.Build:
            return args[0] if self.n_outputs == 1 else args[: self.n_outputs]
        out = self._call_impl(*args)
        if self.config.compare_to_numpy:
            self._compare_to_numpy(args, out)
        if cc.device_sync and any(a.device.type == "cuda" for a in args):
            torch.cuda.synchronize()
        return out

    def _compare_to_numpy(self, args, out):
        """``func`` again on host copies of the windows, held to the result
        within the reference's tolerance."""
        host = [torch.from_numpy(np.array(a.detach().cpu()[self._window(a)])) for a in args]
        res = self.func(*host)
        if not isinstance(res, tuple):
            res = (res,)
        outs = out if isinstance(out, tuple) else (out,)
        for i, r in enumerate(res[: self.n_outputs]):
            got = outs[i].detach().cpu()[self._window(outs[i])]
            np.testing.assert_allclose(got.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)


class StencilFactory:
    """Builds ``FrozenStencil``s with one config and grid geometry."""

    def __init__(self, config: Optional[StencilConfig] = None,
                 grid_indexing: Optional[GridIndexing] = None):
        self.config = config or StencilConfig()
        self.grid_indexing = grid_indexing

    def from_origin_domain(self, func: Callable, origin, domain,
                           n_outputs: int = 1) -> FrozenStencil:
        return FrozenStencil(func, origin, domain, n_outputs, self.config)

    def from_dims_halo(self, func: Callable, compute_dims: Sequence[str],
                       compute_halos: Tuple[int, int] = (0, 0),
                       n_outputs: int = 1) -> FrozenStencil:
        if self.grid_indexing is None:
            raise ValueError("from_dims_halo requires grid_indexing")
        origin, domain = self.grid_indexing.get_origin_domain(compute_dims, compute_halos)
        return FrozenStencil(func, origin, domain, n_outputs, self.config)
