"""One torch thread per test process, for the port's CPU test files.

The driver runs the tests on 6 xdist workers of one 8-core machine, and a
torch process starts a pool of one thread per core: six pools of eight
spin against each other (the ImageNet files took 481 s of wall on 6
workers, 106 s with one thread a process).  A test file imports the
fixture below, which then runs for each of its modules:

    from torch_threads import one_torch_thread  # noqa: F401 (autouse)

The gloo workers of ``torch_dist_worker.py`` use one thread already.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's tests run on one intra-op thread; the count is put
    back after them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
