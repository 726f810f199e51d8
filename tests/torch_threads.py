"""Shared fixture of the port's CPU tests (``tests/test_torch_*.py``).

Several pytest workers share the machine's cores, and PyTorch's intra-op
thread pool, sized to every core in every worker, then waits on itself: a
test-nano decode that takes under a second alone took minutes with four
workers. Each port test module therefore runs torch on one thread and
restores the previous count when it ends.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
