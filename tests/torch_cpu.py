"""A fixture for the port's CPU tests (imported by them, not collected)."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The port's test tensors are tiny and its loops are long chains of
    small operators: one intra-op thread per test process keeps parallel
    test workers from oversubscribing the cores.  Restored afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
