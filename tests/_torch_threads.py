"""torch on one thread in the port's CPU tests.

The suite runs in several pytest-xdist workers on a few cores, beside
XLA's own thread pools. A torch process with its default intra-op threads
then spins on descheduled peers: a port runner test that takes 9 s alone
took 399 s in a full run. On one thread it takes 16 s alone and about as
long in the suite. Test files use it with
``from _torch_threads import one_torch_thread  # noqa: F401``; the
previous thread count is restored after each test.
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
