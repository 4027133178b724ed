"""One torch thread for the port's CPU test modules that import
:func:`one_thread` (no jax)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread for the module that imports this fixture: the
    test workers share the machine's cores, and each worker's default
    thread pool spins against the others'. Integer and exactly
    representable sums do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
