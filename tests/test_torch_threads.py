"""One intra-op thread for the port's CPU tests.

The suite runs in several worker processes on one machine. PyTorch's CPU ops
default to one OpenMP thread per core in every worker, and with a worker per core
the threads of six workers contend for eight cores: a test made of many small
ops (the tiled VAE decode, a ControlNet composition) then runs 100-1000× slower
than alone (0.13 s alone, 122 s beside five more workers, on this repository's
tiled-decode case). Every port test file imports ``one_torch_thread``, which sets
one thread for its module and restores the count after; the JAX side keeps its
own pool.
"""

import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_one_thread_inside_a_port_test_module():
    assert torch.get_num_threads() == 1
