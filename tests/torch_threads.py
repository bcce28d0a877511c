"""The torch CPU threads of the port's tests.

The tier-1 command runs the test files on six worker processes at once, on
as many cores as torch starts threads in each. Each port test file takes
one torch thread for its tests (`one_torch_thread`, an autouse fixture the
file imports), so that the workers do not fight over the cores; the
comparisons with the JAX package hold at any thread count. A test whose
numbers hold at a given thread count runs under `torch_threads(n)`. A CLI
test's subprocess takes ONE_THREAD_ENV, its environment with one OpenMP
thread.
"""

import contextlib
import os

import pytest
import torch

ONE_THREAD_ENV = dict(os.environ, OMP_NUM_THREADS="1")


@contextlib.contextmanager
def torch_threads(n: int):
    """torch's intra-op threads set to n inside, and set back after."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield
