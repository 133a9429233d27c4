"""One intra-op thread for the tool tests' small steps: the suite runs six
pytest workers on the machine's cores, and PyTorch's default (a thread per
core in each worker) oversubscribes them. Import :func:`one_thread` into a
test module to apply it there (it restores the count after the module)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
