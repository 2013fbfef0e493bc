"""A module-scoped fixture that runs a test module's torch CPU ops on one
thread.  The port's exact march and iso march are thousands of small
torch ops a frame; with several pytest-xdist workers sharing the cores,
torch's per-process thread pools oversubscribe them and a module takes
10-17x its time alone.  Import ``one_torch_thread`` into a test module
to apply it there (it restores the thread count after the module)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
