"""Seed recipes: the benchmark's inputs, made on the state's device from the
run's seed.

Each recipe is a module with ``apply(state, params, gen, n_halo)``: it takes
a dycore state (the program's or the reference's: the same field names),
the recipe's parameters from the cell's file, a ``torch.Generator`` on the
state's device seeded by the harness, and the halo width, and returns the
state with its seeded fields replaced (the input state is not written).
Draws are a few large ``torch.rand`` calls in the state's dtype, so the same
seed gives the same arrays on both sides.
"""
