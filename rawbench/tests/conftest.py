"""The benchmark's own tests: `python -m pytest rawbench/tests` from the
root of the checkout.  Tests marked `card` need a CUDA card and skip
without one (the `card` fixture decides, never an import)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# a frame small enough for the CPU, still a multiple of the CFA period
SMALL = {"height": 96, "width": 160, "pad_height": 96, "pad_width": 256}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture
def small_cfg():
    """-> f(cell) = the cell's configuration at the small frame."""
    from rawbench import harness

    def make(workload):
        _, entry = harness.cell_of(harness.load_bench(), workload)
        cfg = harness.load_config(entry)
        cfg["frame"] = dict(SMALL)
        return cfg

    return make
