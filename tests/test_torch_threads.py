"""The port's CPU tests share the machine with the rest of the suite: under
pytest-xdist each worker would run torch with a thread per core, and six
workers on eight cores then spend most of their time waiting for each
other's spinning threads (a two-step train fixture that takes ~25 s alone
took 535 s in six workers). Every tests/test_torch_*.py module imports the
autouse fixture below, which gives torch the worker's share of the cores
for the module's tests and restores the count after them."""

import os

import pytest
import torch


def thread_share() -> int:
    """The cores of this machine over the xdist workers (1 outside xdist),
    at least 1."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // max(1, workers))


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(thread_share())
    yield
    torch.set_num_threads(before)


def test_torch_runs_on_the_workers_share_of_the_cores(monkeypatch):
    assert torch.get_num_threads() == thread_share()
    monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", "6")
    assert thread_share() == max(1, (os.cpu_count() or 1) // 6)
    monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", "1000")
    assert thread_share() == 1
