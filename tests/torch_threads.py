"""One PyTorch intra-op thread for the port's module-6 test files.

Tier-1 runs six xdist workers on the machine's cores; each worker's
PyTorch would start a thread per core, and the small CPU ops of these
files then spend their time in the threads' barriers. Import
``one_thread`` into a test module (autouse, module scope) to run it on
one thread; the count is restored after the module.
"""

import contextlib

import pytest
import torch


@contextlib.contextmanager
def single_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    with single_thread():
        yield
