"""Floating-point precision and device policy.

Unlike ``pace_tpu.dtypes`` there is no environment default: every entry point
takes an explicit torch ``dtype`` (float32 on the card, float64 in the CPU
parity tests) and an explicit ``device``, ``"cuda"`` unless the caller asks
for ``"cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

#: dtypes the entry points and kernels take
#: bfloat16 is the benchmark's control precision (a departure of the copy)
SUPPORTED = (torch.float32, torch.float64, torch.bfloat16)

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``torch.device`` of an entry point's ``device`` argument. A CUDA
    device without a usable card raises: nothing drops silently to the
    CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def check_dtype(dtype) -> torch.dtype:
    if dtype not in SUPPORTED:
        raise ValueError(f"dtype {dtype} not supported; choose from {SUPPORTED}")
    return dtype


def to_tensor(a, device, dtype) -> torch.Tensor:
    """A C-contiguous ``dtype`` tensor on ``device`` holding a copy of array
    data (the kernels take contiguous operands only, and a numpy copy of a
    broadcast view need not be C-ordered)."""
    return torch.from_numpy(np.array(a, dtype=np.float64, order="C")).to(device, dtype)
