"""Tests of the benchmark (`sniffbench/`): run with
`python -m pytest sniffbench/tests -q` from the repo root.  Tests that need
a CUDA card carry the `cuda` marker and skip without one; they decide in
the test, never at import."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA card (skips without one)")
