"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
700 W power limit). A card set below 700 W runs slower under load, so each
traced run prints the card's power limit beside the shares of these peaks."""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_F64_OPS_PER_S = 34e12


def peak_ops_per_s(itemsize: int) -> float:
    """The vector (non-tensor-core) peak for float32 (4) or float64 (8)."""
    return PEAK_F64_OPS_PER_S if itemsize == 8 else PEAK_F32_OPS_PER_S
