"""The benchmark's own tests: python -m pytest benchmark/tests (CPU), and
on the card: python3 -m pytest benchmark/tests -m cuda."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (BENCH, os.path.dirname(BENCH)):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips where torch.cuda.is_available() is false")
