"""One torch thread for the port's CPU tests.

The suite runs several pytest workers (and the workers' rank processes) on
the host's cores.  With torch's default of one intra-op thread a core in
every worker the cores are oversubscribed, and torch's OpenMP threads then
wait on each other: on an 8-core host beside seven busy processes a
torch-heavy test of this suite ran 95 s on the default threads and 18 s
on one.  One thread changes
no check: the tests hold the port to the JAX package at their own bounds,
and the rank processes (``torch_zero_ranks.py``) already run on one.

A test module takes the fixture by importing it; it restores the thread
count after the module's tests.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
