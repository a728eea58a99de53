"""FV3 dynamical core: state, analytic initial conditions, acoustic substep."""
