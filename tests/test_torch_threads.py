"""One intra-op torch thread for each test of the port: the autouse
fixture `one_torch_thread`, imported by each tests/test_torch_*.py that
runs torch on the CPU.

The Tier-1 run starts 6 pytest-xdist workers on the machine's cores, and by
default every torch op of every worker parallelises over all the cores
through OpenMP: the workers' threads then oversubscribe the cores and wait
on each other. On an 8-core machine `test_torch_train.py::
test_train_cli_no_rig_tiny_cpu` takes 4.9 s alone with 8 threads, 4.5 s
alone with 1, and took 97 s inside the Tier-1 run. The port's tests run on
tiny shapes, where one thread a worker loses little."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_a_port_test_runs_on_one_torch_thread():
    assert torch.get_num_threads() == 1
