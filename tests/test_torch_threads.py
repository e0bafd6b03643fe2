"""One intra-op thread for torch while a port test module runs.

The tier-1 run puts six pytest workers on the CPU at once.  With torch's
default of one OpenMP thread a core in every worker, the workers' parallel
regions oversubscribe the cores and spin on each other, and a test of many
small tensor ops runs tens of times slower than alone.  Each
``tests/test_torch_*.py`` module imports ``one_torch_thread``: an autouse,
module-scoped fixture that sets torch's intra-op threads to one for the
module and gives the worker its previous count back afterwards, so that the
JAX package's modules in the same worker run as before.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_a_module_runs_on_one_torch_thread():
    assert torch.get_num_threads() == 1
