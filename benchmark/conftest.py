"""pytest settings of the benchmark's tests (``python -m pytest benchmark/ -q``):
the ``card`` marker, and the fixture that skips a test where no CUDA card is
present, decided when the test runs, never when a module is imported."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    return torch.device("cuda", 0)
