"""One intra-op thread for the port's small-tensor tests.

The suite runs its files in parallel worker processes; PyTorch's default
of one thread per core then oversubscribes the host, and the LM tests'
many small operations slow down several-fold.  Usage, in a test module:

    from tests._torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
