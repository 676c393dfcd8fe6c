"""The benchmark's own tests: CPU tests of its generator, statistics,
counts, reference and harness, and `gpu` tests that run only on the card
(`python -m pytest benchmark/tests -m gpu` there).  The benchmark's folder
goes on sys.path as run.py puts it, and the checkout's root for the port."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
for p in (BENCH, BENCH.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture
def cuda():
    """Skips the test where no CUDA device is visible, deciding inside the
    test and never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
