"""pytest settings of the benchmark's own tests (``python -m pytest benchmark``).

Tests that need an NVIDIA card carry the ``chip`` marker and take the
``card`` fixture, which decides when the test runs, never at import,
whether a card is present."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here; this test runs on the card")
    return torch.device("cuda", 0)
