import numpy as np
import pytest

# NOTE: no XLA_FLAGS here — smoke tests and benches must see ONE device.
# Multi-device tests spawn subprocesses that set the flag themselves.

# The container image has no `hypothesis`; install the seeded-sampling
# fallback so the property-test files collect and run (see
# _hypothesis_fallback.py). A real install always wins.
try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    import _hypothesis_fallback

    _hypothesis_fallback._install()


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips when torch sees no card")


@pytest.fixture
def rng():
    return np.random.default_rng(12345)
