"""The port's CPU tests run torch on one intra-op thread.

The suite runs in several worker processes on the same cores
(pytest-xdist), where torch's intra-op thread pool only contends with the
other workers: its threads spin while they wait, and on a busy machine
that costs several times the work itself. Every port test module takes
``one_torch_thread`` (autouse, module scope: imported into the module),
which sets one thread for the module's tests and restores the count
after them. The tests of the JAX package are not affected.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_modules_run_on_one_thread():
    assert torch.get_num_threads() == 1
