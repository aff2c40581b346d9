"""One torch intra-op thread for a test module of the port: import
``one_torch_thread`` into the module (it is autouse).

The kernels' plain versions run thousands of tiny tensor ops; when the
suite's parallel workers each start a pool of spinning threads on every
core, those ops slow down by one to two orders of magnitude.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
