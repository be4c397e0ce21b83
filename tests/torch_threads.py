"""One torch thread for a port test module.

The suite runs as `pytest -n 6` on eight cores.  There each worker's torch
intra-op pool (one thread per core) contends with the other workers, and
the many small operations of a reduced model or solver wait on one
another's threads: a run that takes seconds alone takes minutes.  A
module that imports `one_torch_thread` runs its tests on one thread and
gives the worker its thread count back at its end.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
