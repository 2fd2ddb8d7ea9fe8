"""Shared set-up of the port's CPU tests.

``one_torch_thread``: an autouse fixture that runs a test module's torch
code on one intra-op thread. pytest-xdist runs the test files in several
worker processes at once, and with torch's default of one OpenMP thread per
core in each, the workers' threads oversubscribe the cores: a render that
takes seconds alone then takes minutes. Alone, one thread is about as fast
at the tests' small sizes. A module takes the fixture by importing it.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
