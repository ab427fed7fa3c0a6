"""One intra-op torch thread for a port test module.

The suite runs its files in parallel workers that share the cores; the
port's CPU tests are small and op-bound, so more intra-op threads per
worker only oversubscribe the cores. A test module takes it with

    from torch_one_thread import one_torch_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
