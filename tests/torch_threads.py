"""A module fixture that bounds PyTorch's CPU threads in a heavy test file.

Under pytest-xdist each of the N worker processes would run PyTorch's
operations on every core of the machine, so N workers ask for about N times
the cores there are, and a heavy file's trainings wait on one another's
threads. A file that imports ``torch_threads`` gives its worker its share of
the cores (all of them outside xdist) while its tests run, and puts the
count back after them.
"""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // workers))
    yield
    torch.set_num_threads(before)
