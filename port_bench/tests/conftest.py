"""The benchmark's own tests: on the CPU at small sizes, and (marked
``card``) on a CUDA card, where the test itself decides whether one is
present.  Run from the root of the checkout:

    python -m pytest port_bench/tests -q
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
