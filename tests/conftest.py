import os
import sys

# allow running plain `pytest tests/` too
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
# tests dir itself (for the _mini_hypothesis fallback import)
sys.path.insert(0, os.path.dirname(__file__))

# smoke tests must see the single real CPU device (the 512-device flag is
# set ONLY inside launch/dryrun.py, per the dry-run contract)
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips inside the test without "
        "one; run on the card)")
