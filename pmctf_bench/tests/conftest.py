"""The benchmark's own tests: CPU tests at tiny sizes, and tests marked
``cuda`` that need the card (each skips without one).

    python3 -m pytest pmctf_bench/tests -q            # here, on the CPU
    python3 -m pytest pmctf_bench/tests -q -m cuda    # on the card
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the port's small test configuration: every layer, tiny widths
TINY_MODEL = dict(decomp_levels=2, num_me_stages=2, channel_mv=8, channel_n=8,
                  features=16, ar_features=16)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
