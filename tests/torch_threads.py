"""One intra-op thread for the port's CPU tests.

The port's tests run many small tensor ops.  The tier-1 run puts six
test processes on one host; with PyTorch's default of one intra-op
thread per core in each of them, every op's parallel region waits on
threads the other processes have preempted, and a test runs many times
slower than alone.  A test module opts in with

    from tests.torch_threads import one_torch_thread  # noqa: F401

(an autouse fixture: the module's tests run with one thread, and the
previous count comes back after them)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
