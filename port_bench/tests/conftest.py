"""Settings of the benchmark's own tests (`python3 -m pytest port_bench`).

Tests that need a CUDA device carry the `cuda` marker and take the
`cuda_device` fixture, which skips them where there is none: the
decision is made when the test runs, never when a module is imported.
"""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs the benchmark on a GPU")
    return torch.device("cuda", 0)
