"""The thread fixture every ``tests/test_torch_*.py`` file imports.

A file takes it with ``from _torch_threads import _one_torch_thread``;
pytest then runs it once for that module.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # One intra-op thread: the CPU tests run several pytest workers on a
    # few cores, and a thread pool per worker costs the small tensor ops
    # here most of their time.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
