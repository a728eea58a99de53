"""Kernel dispatch rule.

Every operator with a hand-written kernel has two implementations in its
module: the CUDA kernel's wrapper and a plain PyTorch version. The choice is
made by where the operands lie, and by nothing else:

- all operands on a CUDA device -> the kernel (a failed build or launch
  raises; there is no fallback);
- all operands on the CPU -> the plain version;
- anything else (mixed devices, another device type) -> ``ValueError``.

There is deliberately no environment switch that routes CUDA tensors to the
plain code: such a switch would hide the kernel from a run that claims to
exercise it.
"""

from __future__ import annotations

import torch


def route(*tensors: torch.Tensor) -> str:
    """``"kernel"`` or ``"plain"`` for the given operands."""
    types = {t.device.type for t in tensors if t is not None}
    if types == {"cuda"}:
        devs = {t.device for t in tensors if t is not None}
        if len(devs) != 1:
            raise ValueError(f"operands on several CUDA devices: {devs}")
        return "kernel"
    if types == {"cpu"}:
        return "plain"
    raise ValueError(f"operands must all lie on one CUDA device or the CPU, got {types}")
