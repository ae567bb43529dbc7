"""CPU tests of the benchmark (`python -m pytest snarkbench/tests -q`).

Tests marked `chip` need a CUDA card: they decide inside the test and skip
here. On the card: `python -m pytest snarkbench/tests -q -m chip`.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")
