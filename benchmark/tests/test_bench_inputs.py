"""The seed recipes: the same seed gives the same arrays, another seed
others, on a small analytic state."""

import dataclasses

import pytest
import torch

from benchmark import harness, registry
from benchmark.reference import model as ref_model


@pytest.fixture(scope="module")
def state():
    raw = registry.driver_dict(registry.workload("c192_dry"), registry.config("baroclinic_c192"))
    raw = registry.merge(raw, {"nx_tile": 12, "nz": 8})
    mt = ref_model.metric_terms(raw)
    return ref_model.initial_state(raw, mt, "cpu", torch.float32)


RECIPES = {
    "pt_perturbation": {"amplitude_K": 0.05},
    "tracers_uniform": {"low": 1e-4, "high": 1.1e-3},
    "moist_tracers": registry.workload("c192_moist_earthlike")["inputs"][0]["params"],
}


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_same_seed_same_arrays(state, recipe):
    r = [{"recipe": recipe, "params": RECIPES[recipe]}]
    a = harness.apply_inputs(state, r, 2**31 + 5, 3)
    b = harness.apply_inputs(state, r, 2**31 + 5, 3)
    c = harness.apply_inputs(state, r, 2**31 + 6, 3)
    for f in dataclasses.fields(state):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f.name
    changed = "pt" if recipe == "pt_perturbation" else "q"
    assert not torch.equal(getattr(a, changed), getattr(c, changed))
    assert not torch.equal(getattr(a, changed), getattr(state, changed))


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_a_block_gets_the_whole_cube_numbers(state, recipe):
    """A rank that holds shards [lo, hi) of the cube applies the recipe to
    its block and gets the whole cube's numbers there: a run on ranks starts
    where a run in one process does."""
    r = [{"recipe": recipe, "params": RECIPES[recipe]}]
    whole = harness.apply_inputs(state, r, 2**31 + 5, 3)
    S = state.pt.shape[0]
    for lo, hi in ((0, 3), (3, 6), (2, 4)):
        view = dataclasses.replace(state, **{
            f.name: getattr(state, f.name)[lo:hi] for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), torch.Tensor)})
        part = harness.apply_inputs(view, r, 2**31 + 5, 3, (lo, hi, S))
        for f in dataclasses.fields(state):
            x = getattr(whole, f.name)
            if isinstance(x, torch.Tensor):
                assert torch.equal(x[lo:hi], getattr(part, f.name)), (f.name, lo, hi)


def test_pt_perturbation_bounds(state):
    out = harness.apply_inputs(state, [{"recipe": "pt_perturbation",
                                        "params": {"amplitude_K": 0.05}}], 3, 3)
    d = out.pt - state.pt
    assert float(d.abs().max()) <= 0.05 + 1e-3
    assert float(d[..., :3, :].abs().max()) == 0.0  # halos untouched


def test_moist_tracers_bounds(state):
    p = RECIPES["moist_tracers"]
    q = harness.apply_inputs(state, [{"recipe": "moist_tracers", "params": p}], 3, 3).q
    assert float(q[:, 0].max()) <= p["qsat_max"] * 1.1 + 1e-7
    assert float(q[:, 1].max()) <= p["condensate_max"]["qliquid"]
    assert float(q.min()) >= 0.0
