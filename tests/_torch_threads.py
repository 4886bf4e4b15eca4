"""One intra-op thread for the port's CPU tests.

The tier-1 run puts several pytest workers on one host, each of which
would start as many torch threads as the host has cores; the workers'
threads then contend for the cores and small eager ops slow by an order
of magnitude. Each ``tests/test_torch_*.py`` module imports
:func:`one_torch_thread` (an autouse fixture), which runs the module on
one torch thread, as the rank processes of ``tests/_torch_ranks.py`` run,
and restores the count after it. What a test computes and checks does
not change.
"""
import pytest


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
