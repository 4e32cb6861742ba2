"""The thread cap of the port's CPU tests.

The suite runs in several xdist workers that share the machine's cores,
and torch would give each worker an OpenMP thread per core. Every
``tests/test_torch_*.py`` imports ``two_torch_threads`` by name, so that
its module runs torch on two intra-op threads, and so does every process
the module starts (gloo ranks, CLI runs, loader workers), which inherits
``OMP_NUM_THREADS``. ``tests/test_torch_imports.py`` checks that each
file takes it.
"""
import pytest
import torch

THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads here and in the processes the module starts,
    restored when the module ends: under ``--dist loadfile`` the worker
    runs other files after it."""
    n = torch.get_num_threads()
    cap = min(n, THREADS)
    torch.set_num_threads(cap)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", str(cap))
        yield
    torch.set_num_threads(n)
