"""Settings of the benchmark's own tests.

    python3 -m pytest benchmark/tests -q                 # CPU, tiny sizes
    python3 -m pytest benchmark/tests -q -m card         # on a CUDA card

Tests marked ``card`` need a CUDA device; the ``cuda_device`` fixture
decides whether there is one (never at import) and skips otherwise.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread a test module: small CPU runs beside other
    workers."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
