"""The benchmark's own tests.  Run from the checkout's root:

    python -m pytest benchmark/tests -q            # CPU
    python -m pytest benchmark/tests -q -m gpu     # on a card

Tests that need a card carry the `gpu` marker and decide inside the test
whether there is one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card")
