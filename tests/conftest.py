import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    # Registered here as well as in pyproject.toml so `pytest tests/...`
    # never warns about an unknown marker, whatever the rootdir.
    config.addinivalue_line(
        "markers",
        "slow: multi-second training / interpret-mode sweeps (nightly tier; "
        "tier-1 runs -m 'not slow')")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card and nvcc (the repro_torch kernels); "
        "skips without one")
