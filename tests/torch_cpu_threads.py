"""A module fixture for the port's heavy CPU test files: torch on one
thread.  The suite runs test processes side by side, and OpenMP threads
that outnumber the cores stall them (six processes of eight threads on
eight cores held a ~20 s training test past 900 s).  Import it into a
test module to apply it there:

    from torch_cpu_threads import one_torch_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
