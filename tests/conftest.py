import os
import sys

# src layout import path (tests also run as `PYTHONPATH=src pytest tests/`)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# NOTE: do NOT set xla_force_host_platform_device_count here -- smoke tests
# and benches must see 1 device (multi-device tests spawn subprocesses).


def pytest_configure(config):
    # tests that need the card carry this marker and skip inside a fixture
    # where torch.cuda.is_available() is False; README.md names the command
    # that runs them on a machine with one
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card and nvcc (skips without one)")
