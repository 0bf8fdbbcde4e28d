"""The benchmark's own tests: ``python -m pytest benchmark/tests``.  Tests
that need the card are marked ``cuda`` and decide inside the test whether
one is there."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")
