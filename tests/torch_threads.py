"""Two intra-op torch threads for a port test module's CPU work.

The tier-1 run puts six test processes on the machine's cores at once; a
torch process spinning up one thread per core in each of them slows every
op many times over. A module opts in with
``from torch_threads import few_torch_threads  # noqa: F401``; the
fixture is autouse and restores the count after the module.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
