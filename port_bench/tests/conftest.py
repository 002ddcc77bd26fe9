"""The benchmark's own tests. Tests marked `card` need a CUDA card and skip
without one; whether there is a card is decided in the `card` fixture,
never while a module is imported. On the card:

    python3 -m pytest port_bench/tests -m card -q -s
"""

import pytest


def pytest_configure(config):
    import torch
    # CPU runs at tiny widths: a few threads a worker, so that parallel
    # workers do not oversubscribe the cores
    torch.set_num_threads(2)
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: runs on the H100 only")
    return torch.device("cuda", 0)
