import os
import sys

ROOT = os.path.join(os.path.dirname(__file__), "..", "..")
# the benchmark by its package name, the port from src/
sys.path[:0] = [os.path.abspath(ROOT), os.path.abspath(os.path.join(ROOT, "src"))]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips inside the test without "
        "one; run on the card)")
