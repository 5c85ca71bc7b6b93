"""Torch's intra-op threads, one share of the cores per test worker.

The suite runs under ``pytest -n N`` (pytest-xdist): N worker processes
on one machine. Left alone, torch gives every worker as many threads as
the machine has cores, so N workers oversubscribe the cores N times
over, and a CPU-bound torch test runs many times slower beside the
others than alone. Every xdist worker imports every test module while it
collects, before any test runs, so setting the count here, at import,
pins it on every worker. The JAX package's tests and XLA's threads are
left alone.
"""

import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", 1))
THREADS = max(1, (os.cpu_count() or 1) // WORKERS)
torch.set_num_threads(THREADS)


def test_torch_threads_are_a_share_of_the_cores():
    assert torch.get_num_threads() == THREADS
    assert THREADS * WORKERS <= max(os.cpu_count() or 1, WORKERS)
