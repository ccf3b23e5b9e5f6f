"""The port's CPU tests run at one torch thread: their plain solvers dispatch
thousands of tiny ops a coordinate, and each op on an intra-op pool that
the other test workers' pools oversubscribe waits on threads. Every
`tests/test_torch_*.py` module imports the fixture:

    from torch_cpu import one_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module's tests; the previous count is
    put back after them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
