"""A frozen copy of the plain PyTorch path of ``pace_tpu_torch``: the grid,
the analytic initial states, the dynamical core and the SHiELD physics.

The benchmark's reference. It is copied, not imported, so that a change to
the program cannot change the yardstick it is judged by. Every operator
is its plain version, on every device; there is no CUDA kernel here. The
modules keep the program's layout, so a later copy can be compared file by
file.
"""
