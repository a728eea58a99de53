"""pytest settings of the benchmark's own tests (``python -m pytest benchmark``).

Tests that need the card carry the ``bench_card`` marker and skip inside
the ``card`` fixture when torch sees no CUDA device; whether there is a
card is never decided while a module is imported.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "bench_card: needs an NVIDIA card; skips without one (inside a fixture)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the port on the card")
    return torch.device("cuda")
