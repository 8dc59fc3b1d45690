"""An autouse fixture for the port's CPU tests: each test runs torch on
one CPU thread.  The suite runs several xdist workers on the machine's
cores, and a thread per core in each swamps it.  A test module imports
it by name::

    from torch_one_thread import one_thread  # noqa: F401

Results within a test share the thread count, and a test that spawns a
child to compare with gives it ``OMP_NUM_THREADS=1`` (a CPU matmul's sums
depend on the count)."""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
