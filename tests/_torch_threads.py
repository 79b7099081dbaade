"""One torch thread per test process for the port's test files.

pytest-xdist runs several test processes on the CPU's cores at once.
torch's intra-op pool in each would otherwise take every core, and the
processes' OpenMP threads then wait on one another: the port's test
files ran about three times slower under ``-n 6`` than with one thread
each.  Each ``tests/test_torch_*.py`` imports :func:`one_torch_thread`, an
autouse fixture of module scope: it sets one torch thread (and
``OMP_NUM_THREADS=1`` for the subprocesses the tests start) for the
module's tests and restores both after.
"""
import os

import pytest


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch at one intra-op thread for the importing module's tests."""
    import torch
    threads, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(threads)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env
