"""The benchmark's own tests: CPU tests at tiny sizes, and tests marked
`chip` that need an NVIDIA GPU and skip without one (the card is decided
inside the `cuda_device` fixture, never at import)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA GPU; skipped without one")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
