"""Model components built from the operators (``fv3``: the dynamical core)."""
