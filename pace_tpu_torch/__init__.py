"""pace_tpu_torch: the PyTorch/CUDA port of pace_tpu.

Same module layout and public array layouts as ``pace_tpu``: fields are
stacked per-shard tensors ``(S, [nq,] K, Y, X)`` with the six cube tiles on
one device, halo-inclusive, interface arrays one longer on their axis.
Everything runs eagerly. Plain PyTorch versions of the hot operators run on
CPU tensors; on CUDA tensors the same entry points launch hand-written
Hopper kernels (``csrc/``, built with ``nvcc`` at first use).

- ``constants`` / ``dtypes``: physical constants, precision and device policy
- ``parallel``: cube topology, shard layout, halo exchange
- ``grid``: gnomonic cubed-sphere grid generation and metric terms
- ``ops``: PPM transport, flux preparation, tracer advection
- ``demos``: the Williamson case-1 tracer-transport demo
"""

from . import constants, dtypes

__version__ = "0.1.0"

__all__ = ["constants", "dtypes", "__version__"]
