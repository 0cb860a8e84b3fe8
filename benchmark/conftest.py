"""pytest settings of the benchmark's own tests (``benchmark/tests``).

Registers the ``cuda`` marker (tests that need a CUDA card; they skip,
with the reason, where torch sees none) and puts the benchmark, its
tests' helpers and the checkout on ``sys.path``.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for path in (HERE, ROOT, os.path.join(HERE, "tests")):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips where torch sees none)")
