"""The benchmark of the PyTorch and CUDA port, ``pace_tpu_torch`` (see README.md)."""
