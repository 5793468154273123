"""One CPU thread per test process: the runs here are a multiphase minute
each, and pytest-xdist's workers would otherwise oversubscribe the
cores many times over."""

import pytest
import torch


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
