"""The benchmark's CPU tests (`python -m pytest bench/tests`).  Tests that
need a CUDA card carry the `card` marker and skip without one; on the
card's machine `python -m pytest -m card bench/tests` runs them."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
for path in (os.path.join(ROOT, "src"), ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")
