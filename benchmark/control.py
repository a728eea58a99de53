"""The control of the check: the reference itself, computed in bfloat16, put
in the program's place.

The configurations state float32 for every field and operator, and their
steps make no matrix products, so TF32 would change nothing; the nearest
lower precision that changes the arithmetic is bfloat16. The control's
outputs (grid, seeded initial state, the warm-up step from that state, the
check step from the program's state before it, the diagnostics fields of
that step) go through the same comparison as the program's
(``harness.reference_gaps``); ``correct`` has to come out false.

The benchmark's own runs never run the control. ``calibrate.py`` reads it
on the card beside the program's readings, and the tests read it on the CPU
at a small size.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from . import check
from .harness import Outputs, compare, reference_outputs

CONTROL_DTYPE = torch.bfloat16


def control_numbers(raw: dict, recipes: List[dict], seed: int, device, h: int,
                    prog: Outputs, diag_names: List[str], variant: str = "bf16",
                    ref: Optional[Outputs] = None) -> Dict[str, float]:
    """The check's numbers with a control as the program, from the same
    inputs as ``prog``, against ``ref`` (the float32 reference's outputs
    from those inputs; made here unless given):

    - ``"bf16"``: the reference computed in bfloat16 throughout (its grid,
      initial state and steps);
    - ``"bf16_state"``: the state held in bfloat16 (each step's input
      rounded to bfloat16), the steps computed in float32, as a program that
      stored its fields in half the bytes would; its grid and initial state
      are the float32 reference's."""
    if ref is None:
        ref = reference_outputs(raw, recipes, seed, device, torch.float32, h, prog, diag_names)
    if variant == "bf16":
        outs = reference_outputs(raw, recipes, seed, device, CONTROL_DTYPE, h, prog, diag_names)
    elif variant == "bf16_state":
        outs = reference_outputs(raw, recipes, seed, device, torch.float32, h, prog, diag_names,
                                 round_to=CONTROL_DTYPE)
    else:
        raise ValueError(f"unknown control {variant!r}")
    return compare(outs, ref, h)


def witness_gaps(raw: dict, device, h: int, prog: Outputs, sides) -> Dict:
    """The check step from ``prog.pre`` by the reference in float64, and
    each of ``sides`` (``{label: (state fields, surface fields)}`` after the
    step) against it, field by field: how far float32 arithmetic itself
    moves each field in one step."""
    w = reference_outputs(raw, [], 0, device, torch.float64, h, prog, [], start=False)
    out = {}
    for label, (post, sfc) in sides.items():
        gaps = check.field_gaps(post, w.post, h, "step.")
        if w.sfc_post is not None:
            gaps.update(check.field_gaps(sfc or {}, w.sfc_post, h, "step.surface."))
        out[label] = gaps
    return out
