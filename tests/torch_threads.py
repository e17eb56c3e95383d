"""One intra-op thread for the port's CPU tests.

Each port test module imports ``one_torch_thread``, which pytest then uses
for every test of the module: torch runs its CPU ops on one thread there and
gets its thread count back after the module.  The test runner's workers
share the machine's cores, and torch's default (a thread per core in every
worker) oversubscribes them many times over; one thread a worker lets them
run side by side.  The port's tests pass on one thread as on many.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
